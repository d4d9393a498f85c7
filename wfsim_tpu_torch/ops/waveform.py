"""Photons -> per-channel waveform grid (counterpart of wfsim_tpu/ops/waveform.py).

This is the reference's innermost hot loop ``Pulse.add_current``
(reference: wfsim/core/pulse.py:276-318): a photon at window-relative time
``t`` adds ``gain * templates[t % dt]`` (a 22-sample SPE current template,
one per 1-ns sub-sample phase) starting at sample ``t // dt``.

On the card the superposition, the ADC conversion, the noise overlay
(realistic config) and the window epilogue run fused in one hand-written
kernel (``csrc/superpose_adc.cu``), which stores the int16 grid directly.  ``superpose_adc_ref`` is its plain
PyTorch twin: it adds the same float32 products in the same per-sample
order (photon order within each row), so the two agree bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import Kernel, P, I, F, ptr, stream_of

__all__ = ['make_templates', 'photons_to_waveform_ref', 'noise_overlay_ref',
           'superpose_adc', 'superpose_adc_ref']


def make_templates(pe_pulse_ts, pe_pulse_ys,
                   sample_duration: int = 10,
                   samples_before: int = 2,
                   samples_after: int = 20) -> np.ndarray:
    """(sample_duration, template_length) SPE current template bank, built as
    the reference does (wfsim/core/pulse.py:146-187); row r applies to
    photons with ``t % dt == r``."""
    ts = np.asarray(pe_pulse_ts, dtype=np.float64)
    cdf_y = np.cumsum(np.asarray(pe_pulse_ys, dtype=np.float64))

    def pe_pulse_cdf(x):
        return np.interp(x, ts, cdf_y, left=0.0, right=1.0)

    samples = np.linspace(-samples_before * sample_duration,
                          samples_after * sample_duration,
                          1 + samples_before + samples_after)
    templates = []
    for r in range(sample_duration):
        current = np.diff(pe_pulse_cdf(samples - r)) / sample_duration
        current *= (1 / sample_duration) / np.sum(current)
        templates.append(current)
    return np.asarray(templates, dtype=np.float32)


def photons_to_waveform_ref(t, gain, row_ptr, templates, *, n_samples: int):
    """Float32 current waveform (rows, n_samples) of row-sorted photons.

    :param t: (N,) int32 window-relative photon times [ns], >= 0, sorted by
        row (any order within a row)
    :param gain: (N,) float32 per-photon gain
    :param row_ptr: (rows + 1,) int32 offsets of each row's photons
    :param templates: (dt, L) float32 template bank

    Sums photon by photon in row order: step ``i`` adds the ``i``-th photon
    of every row at once (rows never collide within a step), so each
    sample accumulates ``fl(gain * T)`` in exactly the order the kernel
    does.
    """
    dt, L = templates.shape
    n_rows = row_ptr.shape[0] - 1
    W = torch.zeros((n_rows, n_samples + L), dtype=torch.float32,
                    device=t.device)
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    if n_rows == 0 or t.shape[0] == 0:
        return W[:, :n_samples]
    k = torch.arange(L, device=t.device)
    for i in range(int(counts.max())):
        rows = torch.nonzero(counts > i).squeeze(1)
        p = row_ptr[rows].to(torch.int64) + i
        tt = t[p]
        s = torch.div(tt, dt, rounding_mode='floor').to(torch.int64)
        r = (tt - s * dt).to(torch.int64)
        cols = torch.clamp_max(s[:, None] + k[None, :], n_samples + L - 1)
        # photons starting past the grid land in the dropped pad columns
        cols = torch.where(s[:, None] < n_samples, cols, n_samples + k[None, :])
        rr = rows[:, None].expand_as(cols)
        W[rr, cols] = W[rr, cols] + gain[p][:, None] * templates[r]
    return W[:, :n_samples]


def noise_overlay_ref(bank, noise_ix, ch_left, *, n_channels: int,
                      n_samples: int):
    """(rows, n_samples) int32 noise of each row's trace: row ``w * C + c``
    reads ``bank[c, (noise_ix[w] + u - ch_left[row]) % L]`` for ``c < Cn``
    and is 0 on rows past the bank (wfsim_tpu/pipeline/digitize.py:67
    _noise_gather; reference rawdata.py:407-431)."""
    Cn, L = bank.shape
    dev = ch_left.device
    n_rows = ch_left.shape[0]
    rows = torch.arange(n_rows, device=dev)
    c = rows % n_channels
    on = torch.nonzero(c < Cn).squeeze(1)
    out = torch.zeros((n_rows, n_samples), dtype=torch.int32, device=dev)
    u = torch.arange(n_samples, dtype=torch.int64, device=dev)
    x = (noise_ix.to(torch.int64)[on // n_channels, None] + u[None, :]
         - ch_left.to(torch.int64)[on, None])
    flat = c[on, None] * L + torch.remainder(x, L)
    out[on] = bank.reshape(-1)[flat].to(torch.int32)
    return out


def superpose_adc_ref(t, gain, row_ptr, templates, ch_left, ch_right, has, *,
                      current_2_adc: float, baseline: int, n_samples: int,
                      noise_bank=None, noise_ix=None, n_channels: int = 0):
    """Plain twin of the superpose_adc kernel: waveform, then
    ``-round_half_even(W * current_2_adc)`` (int32), plus the noise overlay
    (with a bank), the baseline and a clip at 0 inside each row's window
    ``[ch_left, ch_right]`` for rows with ``has``, then int16
    (wfsim_tpu/pipeline/digitize.py:299-319)."""
    W = photons_to_waveform_ref(t, gain, row_ptr, templates,
                                n_samples=n_samples)
    c2a = float(np.float32(current_2_adc))
    adc = (-torch.round(W * c2a)).to(torch.int32)
    idx = torch.arange(n_samples, dtype=torch.int32, device=t.device)
    in_win = ((idx[None, :] >= ch_left[:, None])
              & (idx[None, :] <= ch_right[:, None]) & has[:, None])
    add = torch.full_like(adc, baseline)
    if noise_bank is not None:
        add = add + noise_overlay_ref(noise_bank, noise_ix, ch_left,
                                      n_channels=n_channels,
                                      n_samples=n_samples)
    data = adc + torch.where(in_win, add, 0)
    data = torch.where(in_win, torch.clamp_min(data, 0), data)
    return data.to(torch.int16)


_kernel = Kernel('wfsim_superpose_adc',
                 [P, P, P, I, I, P, I, I, P, P, P, F, I, P, I, I, P, I, P, P])


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f'{name}: dtype {x.dtype}, expected {dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(x.shape)}, expected {shape}')
    if x.device != device:
        raise ValueError(f'{name}: on {x.device}, expected {device}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: not contiguous')


def superpose_adc(t, gain, row_ptr, templates, ch_left, ch_right, has, *,
                  current_2_adc: float, baseline: int, n_samples: int,
                  noise_bank=None, noise_ix=None, n_channels: int = 0):
    """(rows, n_samples) int16 digitized grid of row-sorted photons.

    With ``noise_bank`` ((Cn, L) int16, channel-major), ``noise_ix`` ((B,)
    int32, one bank offset per window, 0 <= noise_ix < 2^30) and
    ``n_channels`` (C, rows per window: row = w * C + c), rows with c < Cn
    get the noise overlay in their window.

    CPU tensors go to :func:`superpose_adc_ref`; CUDA tensors launch the
    hand-written kernel (``csrc/superpose_adc.cu``)."""
    dev = t.device
    n = t.shape[0]
    n_rows = row_ptr.shape[0] - 1
    _check('t', t, torch.int32, (n,), dev)
    _check('gain', gain, torch.float32, (n,), dev)
    _check('row_ptr', row_ptr, torch.int32, (n_rows + 1,), dev)
    _check('templates', templates, torch.float32, tuple(templates.shape), dev)
    _check('ch_left', ch_left, torch.int32, (n_rows,), dev)
    _check('ch_right', ch_right, torch.int32, (n_rows,), dev)
    _check('has', has, torch.bool, (n_rows,), dev)
    if n and int(t.min()) < 0:
        raise ValueError('photon times must be window-relative and >= 0')
    bank_args = (None, 0, 0, None, 0)
    if noise_bank is not None:
        Cn, L = noise_bank.shape
        if n_channels <= 0 or n_rows % n_channels:
            raise ValueError(f'{n_rows} rows are not whole windows of '
                             f'{n_channels} channels')
        _check('noise_bank', noise_bank, torch.int16, (Cn, L), dev)
        _check('noise_ix', noise_ix, torch.int32, (n_rows // n_channels,),
               dev)
        if not 0 < L < 2 ** 30:
            raise ValueError(f'noise bank length {L} out of range')
        if noise_ix.numel() and not (0 <= int(noise_ix.min())
                                     and int(noise_ix.max()) < 2 ** 30):
            raise ValueError('noise_ix must lie in [0, 2^30)')
        bank_args = (ptr(noise_bank), L, Cn, ptr(noise_ix), n_channels)
    kw = dict(current_2_adc=current_2_adc, baseline=baseline,
              n_samples=n_samples, noise_bank=noise_bank, noise_ix=noise_ix,
              n_channels=n_channels)
    if dev.type == 'cpu':
        return superpose_adc_ref(t, gain, row_ptr, templates, ch_left,
                                 ch_right, has, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f'superpose_adc on {dev}')
    out = torch.empty((n_rows, n_samples), dtype=torch.int16, device=dev)
    if n_rows == 0 or n_samples == 0:
        return out
    dt, L = templates.shape
    _kernel(ptr(t), ptr(gain), ptr(row_ptr), n_rows, n_samples,
            ptr(templates), dt, L, ptr(ch_left), ptr(ch_right), ptr(has),
            float(np.float32(current_2_adc)), int(baseline), *bank_args,
            ptr(out), stream_of(dev))
    return out
