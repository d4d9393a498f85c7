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
``superpose_adc_full`` and its twin ``superpose_adc_full_ref`` digitize
the whole XENONnT digitizer grid (high-energy copies, bottom-array sum)
from the same single pass over the photons, or the grid without HE rows
(XENON1T: TPC rows, then zero rows).
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import Kernel, P, I, F, ptr, stream_of, check_tensor as _check

__all__ = ['make_templates', 'photons_to_waveform_ref', 'noise_overlay_ref',
           'superpose_adc', 'superpose_adc_ref', 'superpose_adc_full',
           'superpose_adc_full_ref']


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


def bank_reads_ref(bank, noise_ix, ch_left, cols, *, n_samples: int):
    """(R, n_samples) int32: row r reads ``bank[cols[r], (noise_ix[r] + u -
    ch_left[r]) % L]`` (one noise offset and one bank column per row)."""
    L = bank.shape[1]
    u = torch.arange(n_samples, dtype=torch.int64, device=ch_left.device)
    x = noise_ix.to(torch.int64)[:, None] + u[None, :] \
        - ch_left.to(torch.int64)[:, None]
    flat = cols.to(torch.int64)[:, None] * L + torch.remainder(x, L)
    return bank.reshape(-1)[flat].to(torch.int32)


def noise_overlay_ref(bank, noise_ix, ch_left, *, n_channels: int,
                      n_samples: int):
    """(rows, n_samples) int32 noise of each row's trace: row ``w * C + c``
    reads ``bank[c, (noise_ix[w] + u - ch_left[row]) % L]`` for ``c < Cn``
    and is 0 on rows past the bank (wfsim_tpu/pipeline/digitize.py:67
    _noise_gather; reference rawdata.py:407-431)."""
    Cn = bank.shape[0]
    dev = ch_left.device
    n_rows = ch_left.shape[0]
    rows = torch.arange(n_rows, device=dev)
    c = rows % n_channels
    on = torch.nonzero(c < Cn).squeeze(1)
    out = torch.zeros((n_rows, n_samples), dtype=torch.int32, device=dev)
    out[on] = bank_reads_ref(bank, noise_ix[on // n_channels], ch_left[on],
                             c[on], n_samples=n_samples)
    return out


def _adc_and_window_ref(t, gain, row_ptr, templates, ch_left, ch_right, has,
                        *, current_2_adc: float, n_samples: int):
    """(adc, in_win): ``-round_half_even(W * current_2_adc)`` (int32) of
    every row and the mask of each row's window ``[ch_left, ch_right]``
    (rows with ``has`` only)."""
    W = photons_to_waveform_ref(t, gain, row_ptr, templates,
                                n_samples=n_samples)
    c2a = float(np.float32(current_2_adc))
    adc = (-torch.round(W * c2a)).to(torch.int32)
    idx = torch.arange(n_samples, dtype=torch.int32, device=t.device)
    in_win = ((idx[None, :] >= ch_left[:, None])
              & (idx[None, :] <= ch_right[:, None]) & has[:, None])
    return adc, in_win


def superpose_adc_ref(t, gain, row_ptr, templates, ch_left, ch_right, has, *,
                      current_2_adc: float, baseline: int, n_samples: int,
                      noise_bank=None, noise_ix=None, n_channels: int = 0):
    """Plain twin of the superpose_adc kernel: waveform, then
    ``-round_half_even(W * current_2_adc)`` (int32), plus the noise overlay
    (with a bank), the baseline and a clip at 0 inside each row's window
    ``[ch_left, ch_right]`` for rows with ``has``, then int16
    (wfsim_tpu/pipeline/digitize.py:299-319)."""
    adc, in_win = _adc_and_window_ref(t, gain, row_ptr, templates, ch_left,
                                      ch_right, has,
                                      current_2_adc=current_2_adc,
                                      n_samples=n_samples)
    return _epilogue_ref(adc, in_win, ch_left, baseline=baseline,
                         noise_bank=noise_bank, noise_ix=noise_ix,
                         n_channels=n_channels)


def _epilogue_ref(adc, in_win, ch_left, *, baseline, noise_bank, noise_ix,
                  n_channels, wide=False):
    """int16 rows (int32 with ``wide``): adc plus, inside the window, the
    noise overlay (with a bank) and the baseline, clipped at 0."""
    add = torch.full_like(adc, baseline)
    if noise_bank is not None:
        add = add + noise_overlay_ref(noise_bank, noise_ix, ch_left,
                                      n_channels=n_channels,
                                      n_samples=adc.shape[1])
    data = adc + torch.where(in_win, add, 0)
    data = torch.where(in_win, torch.clamp_min(data, 0), data)
    return data if wide else data.to(torch.int16)


_OVERFLOW = ('an in-window sample of the full grid reached 2^16 (|adc x '
             'deamplification factor| too large): its int16 sample no '
             'longer tells whether the int32 value is below the ZLE '
             'threshold, as wfsim_tpu compares it')


def _wrap_i32(x):
    """int64 values reduced to int32 modulo 2^32 (XLA's wrapping int32
    arithmetic), kept as int64."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def superpose_adc_full_ref(t, gain, row_ptr, templates, ch_left, ch_right,
                           has, *, current_2_adc: float, baseline: int,
                           n_samples: int, n_channels: int,
                           n_channels_total: int, n_top: int,
                           he_start: int | None, sum_channel: int | None,
                           deamp: int, noise_bank=None, noise_ix=None):
    """Plain twin of the superpose_adc_full kernel: the (B, C_all, T) int16
    digitizer grid of B windows (wfsim_tpu/pipeline/digitize.py:341-435).

    Rows 0..C-1 are :func:`superpose_adc_ref`'s.  HE row ``he_start + c``
    (c < n_top) is ``adc * deamp`` of TPC row c, plus (inside TPC row c's
    window) the noise of bank column ``he_start + c`` when the bank has
    it, the baseline and a clip at 0.  Row ``sum_channel`` is the sum over
    the bottom rows (c >= n_top) of ``adc * deamp``, with no window.
    Every other row is 0.  With ``he_start`` and ``sum_channel`` None (the
    grid without HE rows, wfsim_tpu's ``he_on`` false: XENON1T) there are
    neither HE copies nor a sum row: rows C..C_all-1 are all 0.  Products
    and sums wrap as int32 and the int16
    cast keeps the low 16 bits, as wfsim_tpu's int32 arithmetic and
    ``astype(int16)`` do (the sum is exact in int64 here; its low 16 bits
    are those of the wrapped int32 sum).  Raises ``OverflowError`` where
    an in-window value reaches 2^16 (see :func:`superpose_adc_full`)."""
    C, T = n_channels, n_samples
    n_rows = row_ptr.shape[0] - 1
    B = n_rows // C
    dev = t.device
    adc, in_win = _adc_and_window_ref(t, gain, row_ptr, templates, ch_left,
                                      ch_right, has,
                                      current_2_adc=current_2_adc,
                                      n_samples=T)
    out = torch.zeros((B, n_channels_total, T), dtype=torch.int16, device=dev)
    tpc = _epilogue_ref(adc, in_win, ch_left, baseline=baseline,
                        noise_bank=noise_bank, noise_ix=noise_ix,
                        n_channels=C, wide=True)
    overflow = bool((tpc[in_win] >= 2 ** 16).any())
    out[:, :C] = tpc.to(torch.int16).reshape(B, C, T)
    if he_start is None:
        if overflow:
            raise OverflowError(_OVERFLOW)
        return out

    rows = torch.arange(n_rows, device=dev)
    top = rows[rows % C < n_top]
    add = torch.full((top.shape[0], T), baseline, dtype=torch.int64,
                     device=dev)
    if noise_bank is not None:
        cols = he_start + top % C
        on = cols < noise_bank.shape[0]
        add[on] += bank_reads_ref(noise_bank, noise_ix[top[on] // C],
                                  ch_left[top[on]], cols[on], n_samples=T)
    win = in_win[top]
    he = _wrap_i32(adc[top].to(torch.int64) * deamp
                   + torch.where(win, add, 0))
    he = torch.where(win, torch.clamp_min(he, 0), he)
    if overflow or bool((he[win] >= 2 ** 16).any()):
        raise OverflowError(_OVERFLOW)
    out[:, he_start:he_start + n_top] = he.to(torch.int16).reshape(
        B, n_top, T)
    bottom = adc.reshape(B, C, T)[:, n_top:].to(torch.int64)
    out[:, sum_channel] = _wrap_i32(bottom * deamp).sum(dim=1).to(
        torch.int16)
    return out


def _check_inputs(t, gain, row_ptr, templates, ch_left, ch_right, has,
                  noise_bank, noise_ix, n_channels):
    """Raise on what the superpose kernels do not take; return the
    ctypes arguments of the bank ``(bank, L, Cn, noise_ix)``."""
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
    if noise_bank is None:
        return (None, 0, 0, None)
    Cn, L = noise_bank.shape
    if n_channels <= 0 or n_rows % n_channels:
        raise ValueError(f'{n_rows} rows are not whole windows of '
                         f'{n_channels} channels')
    _check('noise_bank', noise_bank, torch.int16, (Cn, L), dev)
    _check('noise_ix', noise_ix, torch.int32, (n_rows // n_channels,), dev)
    if not 0 < L < 2 ** 30:
        raise ValueError(f'noise bank length {L} out of range')
    if noise_ix.numel() and not (0 <= int(noise_ix.min())
                                 and int(noise_ix.max()) < 2 ** 30):
        raise ValueError('noise_ix must lie in [0, 2^30)')
    return (ptr(noise_bank), L, Cn, ptr(noise_ix))


_kernel = Kernel('wfsim_superpose_adc',
                 [P, P, P, I, I, P, I, I, P, P, P, F, I, P, I, I, P, I, P, P])


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
    n_rows = row_ptr.shape[0] - 1
    bank_args = _check_inputs(t, gain, row_ptr, templates, ch_left, ch_right,
                              has, noise_bank, noise_ix, n_channels)
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
            n_channels, ptr(out), stream_of(dev))
    return out


_full_kernel = Kernel('wfsim_superpose_adc_full',
                      [P, P, P, I, I, P, I, I, P, P, P, F, I, P, I, I, P,
                       I, I, I, I, I, I, I, P, P, P])


def superpose_adc_full(t, gain, row_ptr, templates, ch_left, ch_right, has,
                       *, current_2_adc: float, baseline: int, n_samples: int,
                       n_channels: int, n_channels_total: int, n_top: int,
                       he_start: int | None, sum_channel: int | None,
                       deamp: int, noise_bank=None, noise_ix=None):
    """(B, n_channels_total, n_samples) int16 full digitizer grid of B
    windows of ``n_channels`` TPC rows each (row = w * C + c; arguments as
    :func:`superpose_adc`): TPC rows, high-energy copies of the ``n_top``
    top rows on ``he_start..``, the bottom-array sum on ``sum_channel``
    (see :func:`superpose_adc_full_ref`).  ``noise_bank`` may be as wide as
    the grid; its columns past the TPC feed the HE rows.  With
    ``he_start`` and ``sum_channel`` None the grid has no HE rows and no
    sum row: TPC rows, then zero rows up to ``n_channels_total``.

    CPU tensors go to :func:`superpose_adc_full_ref`; CUDA tensors launch
    the hand-written kernel (``csrc/superpose_adc.cu``,
    ``wfsim_superpose_adc_full``: one pass over the photons, atomic int32
    bottom sum, one follow-on launch for the sum and gap rows; without HE
    rows the same launches with zero HE copies and no sum row).

    Raises ``OverflowError`` where an in-window sample reaches 2^16: the
    port's ZLE reads the int16 grid (``zle_all_channels(nonneg=True)``),
    which is exact below that (wfsim_tpu compares the int32 values); with
    the SPE gains >= 0 of the synthetic spectrum the HE values never pass
    the baseline."""
    dev = t.device
    n_rows = row_ptr.shape[0] - 1
    C, C_all = n_channels, n_channels_total
    if C <= 0 or n_rows % C:
        raise ValueError(f'{n_rows} rows are not whole windows of {C} '
                         f'channels')
    he_on = he_start is not None
    if he_on != (sum_channel is not None):
        raise ValueError('he_start and sum_channel are both set (HE rows '
                         'and a sum row) or both None (neither)')
    if not (0 <= n_top <= C <= C_all and (
            not he_on or C <= he_start and he_start + n_top <= sum_channel
            < C_all)):
        raise ValueError(f'grid layout C={C} n_top={n_top} he_start='
                         f'{he_start} sum_channel={sum_channel} C_all={C_all}'
                         f' is not TPC < HE <= sum < total')
    if not -2 ** 31 <= int(deamp) < 2 ** 31:
        raise ValueError(f'deamplification factor {deamp} does not fit int32')
    if noise_bank is not None and noise_bank.shape[0] > C_all:
        raise ValueError(f'noise bank of {noise_bank.shape[0]} channels is '
                         f'wider than the {C_all}-row grid')
    bank_args = _check_inputs(t, gain, row_ptr, templates, ch_left, ch_right,
                              has, noise_bank, noise_ix, C)
    kw = dict(current_2_adc=current_2_adc, baseline=baseline,
              n_samples=n_samples, n_channels=C, n_channels_total=C_all,
              n_top=n_top, he_start=he_start, sum_channel=sum_channel,
              deamp=int(deamp), noise_bank=noise_bank, noise_ix=noise_ix)
    if dev.type == 'cpu':
        return superpose_adc_full_ref(t, gain, row_ptr, templates, ch_left,
                                      ch_right, has, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f'superpose_adc_full on {dev}')
    B = n_rows // C
    out = torch.empty((B, C_all, n_samples), dtype=torch.int16, device=dev)
    if n_rows == 0 or n_samples == 0:
        return out
    # the (B, T) int32 sum rows (with a sum row), then the overflow word
    scratch = torch.empty((B * n_samples if he_on else 0) + 1,
                          dtype=torch.int32, device=dev)
    dt, L = templates.shape
    layout = ((n_top, he_start, sum_channel) if he_on else (0, C, -1))
    _full_kernel(ptr(t), ptr(gain), ptr(row_ptr), n_rows, n_samples,
                 ptr(templates), dt, L, ptr(ch_left), ptr(ch_right),
                 ptr(has), float(np.float32(current_2_adc)), int(baseline),
                 *bank_args, C, C_all, n_top, *layout, int(deamp),
                 ptr(scratch), ptr(out), stream_of(dev))
    if int(scratch[-1]):
        raise OverflowError(_OVERFLOW)
    return out
