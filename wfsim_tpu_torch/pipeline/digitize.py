"""Window digitization: photon arena -> int16 grid -> ZLE -> strax records
(counterpart of wfsim_tpu/pipeline/digitize.py: gather_digitize with its
noise overlay, :183-466, the one-window digitize_window, :96-178, and the
dense pack_records, :469-519; reference: wfsim/core/rawdata.py:204-311,
398-458).

A batch of B windows is one grid of B*C rows (window w, TPC channel c ->
row w*C + c).  The glue here is plain torch: gathering each window's
photons from the arena through its piece table, the per-row extents, the
row sort, and the record cumsum.  The three device passes are hand-written
kernels with plain twins: ``ops.waveform.superpose_adc`` (or
``superpose_adc_full`` on the full digitizer grid), ``ops.zle.zle_all_channels``
and :func:`pack_records`.

Two grids, chosen where wfsim_tpu chooses them (digitize.py:290): the slim
grid of the C TPC rows, and the full digitizer grid of
``n_channels_total`` rows a window when the integer deamplification
factor is not 0 or the noise bank is wider than the TPC.  On XENONnT the
full grid holds the TPC rows, high-energy copies of the top array and the
bottom-array sum; on XENON1T (no HE channel range, wfsim_tpu's ``he_on``
false) the TPC rows and zero rows.  Record channels are grid rows, so HE
records carry channels 500-752.

With noise on, the grid is the noisy waveform itself and the dense
records carry it.  Left out by design (wfsim_tpu's relay transport):
``_pack_streams``, ``pack_records_encoded``, ``pack_records_accumulate``,
``decode_records``, ``compact_mask4``/``expand_mask4`` and the noise
strip/re-add pair (the residual grid and ``add_noise_host``).
"""
from __future__ import annotations

import torch

from .._build import Kernel, P, I, ptr, stream_of
from ..ops.waveform import superpose_adc, superpose_adc_full
from ..ops.zle import zle_all_channels

__all__ = ['gather_digitize', 'digitize_window', 'window_photons',
           'full_grid', 'full_grid_rows', 'he_on', 'pack_records',
           'pack_records_ref',
           'SAMPLES_PER_RECORD']

SAMPLES_PER_RECORD = 110


def window_photons(const, arena_t, arena_ch, arena_gain, pieces, *,
                   n_samples: int):
    """The superposition inputs of a window batch: its photons gathered
    from the arena through the piece table and sorted by row
    (row = window * C + channel), plus each row's window.

    :param arena_t/ch/gain: (A,) int32 / int32 / float32 photon arena;
        times are ns relative to each buffer's base, channel -1 marks a
        photon that was dropped
    :param pieces: (B, P, 3) ``[arena_lo, count, t_offset]`` per window
        piece (count 0 marks padding); ``t_offset`` moves a piece's times
        into its window's frame
    :returns: dict of t, gain (sorted by row, arena order within a row),
        row_ptr (B*C + 1,) int32, ch_left/ch_right (B*C,) int32, has bool
    """
    dev = arena_t.device
    B = int(pieces.shape[0])
    T = n_samples
    dt = const.sample_duration
    C = const.n_tpc_pmts
    R = B * C

    pieces = pieces.to(dev, torch.int64).reshape(-1, 3)
    lo, cnt, toff = pieces[:, 0], pieces[:, 1], pieces[:, 2]
    w_of_piece = torch.arange(B, device=dev).repeat_interleave(
        pieces.shape[0] // max(B, 1))
    first = torch.cumsum(cnt, dim=0) - cnt
    n_ph = int(cnt.sum())
    aidx = torch.arange(n_ph, device=dev) + torch.repeat_interleave(
        lo - first, cnt)
    t = (arena_t[aidx].to(torch.int64)
         + torch.repeat_interleave(toff, cnt)).to(torch.int32)
    ch = arena_ch[aidx]
    gain = arena_gain[aidx]
    w = torch.repeat_interleave(w_of_piece, cnt)
    keep = ch >= 0
    t, ch, gain, w = t[keep], ch[keep], gain[keep], w[keep]
    rows = w * C + ch.to(torch.int64)

    # per-row extents (reference: pulse.py:117-127, rawdata.py:231-235)
    BIG = 2 ** 30
    s_ph = torch.div(t, dt, rounding_mode='floor')
    smin = torch.full((R,), BIG, dtype=torch.int32, device=dev)
    smax = torch.full((R,), -BIG, dtype=torch.int32, device=dev)
    smin.scatter_reduce_(0, rows, s_ph, reduce='amin')
    smax.scatter_reduce_(0, rows, s_ph, reduce='amax')
    has = smax >= smin
    pl = smin - const.samples_to_store_before - const.samples_before_pulse_center
    pr = smax + const.samples_to_store_after + const.samples_after_pulse_center
    ch_left = torch.clamp(pl - const.trigger_window, 0, T - 1).to(torch.int32)
    ch_right = torch.clamp(pr + const.trigger_window, 0, T - 1).to(torch.int32)

    rows_sorted, order = torch.sort(rows, stable=True)
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows_sorted, minlength=R),
                               dim=0).to(torch.int32)
    return dict(t=t[order].contiguous(), gain=gain[order].contiguous(),
                row_ptr=row_ptr, ch_left=ch_left, ch_right=ch_right, has=has)


def noise_on(params, const) -> bool:
    return bool(const.enable_noise and params.noise_bank is not None)


def full_grid(params, const) -> bool:
    """Whether a batch digitizes the full digitizer grid: the integer
    deamplification factor is not 0 (reference rawdata.py:242 casts it),
    or the noise bank covers rows past the TPC (wfsim_tpu
    digitize.py:290)."""
    return const.high_energy_deamp_int != 0 or (
        noise_on(params, const)
        and params.noise_bank.shape[0] > const.n_tpc_pmts)


def he_on(const) -> bool:
    """Whether the full grid carries the HE copies and the sum row: the
    XENONnT layout with an HE channel range (wfsim_tpu digitize.py:346);
    otherwise (XENON1T) it is the TPC rows and zero rows."""
    return (const.detector == 'XENONnT'
            and const.he_channel_end >= const.he_channel_start)


def full_grid_rows(x, const):
    """(B, C) per-row values of the TPC rows -> (B, n_channels_total) of
    the full grid: with HE rows the HE row of top channel c takes TPC row
    c's value; the sum row and the gap rows are 0 (False) — they have no
    window (reference rawdata.py:250-254)."""
    B, C = x.shape
    n_top = const.n_top_pmts
    out = torch.zeros((B, const.n_channels_total), dtype=x.dtype,
                      device=x.device)
    out[:, :C] = x
    if he_on(const):
        out[:, const.he_channel_start:const.he_channel_start + n_top] = \
            x[:, :n_top]
    return out


def gather_digitize(params, const, arena_t, arena_ch, arena_gain, pieces,
                    noise_ix=None, *, n_samples: int, max_intervals: int = 64,
                    full: bool | None = None):
    """Digitize a batch of B windows straight from the device photon arena
    (arguments as :func:`window_photons`).

    :param noise_ix: (B,) int32 host-drawn noise-bank offset per window
        (required with noise on, ignored otherwise)
    :param full: digitize the full grid (default: :func:`full_grid`)
    :returns: dict of data (B, R, T) int16, left_all/right_all (B, R)
        int32, has (B, R) bool, starts/ends (B, R, K) int32 (relative to
        left_all), counts (B, R) int32, with R = C TPC rows on the slim
        grid and ``n_channels_total`` on the full one
    """
    noisy = noise_on(params, const)
    if full is None:
        full = full_grid(params, const)
    B = int(pieces.shape[0])
    C = const.n_tpc_pmts
    T = n_samples
    K = max_intervals
    ph = window_photons(const, arena_t, arena_ch, arena_gain, pieces,
                        n_samples=T)
    dev = ph['t'].device
    noise = {}
    if noisy:
        if noise_ix is None:
            raise ValueError('noise is on: gather_digitize needs noise_ix')
        noise = dict(noise_bank=params.noise_bank,
                     noise_ix=noise_ix.to(dev, torch.int32))
    args = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
            ph['ch_left'], ph['ch_right'], ph['has'])
    kw = dict(current_2_adc=const.current_2_adc,
              baseline=const.digitizer_reference_baseline, n_samples=T,
              n_channels=C, **noise)
    left = ph['ch_left'].reshape(B, C)
    right = ph['ch_right'].reshape(B, C)
    has = ph['has'].reshape(B, C)
    if full:
        R = const.n_channels_total
        he = he_on(const)
        data = superpose_adc_full(
            *args, n_channels_total=R, n_top=const.n_top_pmts,
            he_start=const.he_channel_start if he else None,
            sum_channel=const.sum_signal_channel if he else None,
            deamp=const.high_energy_deamp_int, **kw)
        left, right, has = (full_grid_rows(x, const)
                            for x in (left, right, has))
    else:
        R = C
        data = superpose_adc(*args, **kw).reshape(B, C, T)
    zthr = params.zle_thresholds[:R].repeat(B).contiguous()
    starts, ends, counts = zle_all_channels(
        data.reshape(B * R, T), zthr, left.reshape(-1), right.reshape(-1),
        has.reshape(-1), holdoff=2 * const.trigger_window + 1,
        trigger_window=const.trigger_window, max_intervals=K, nonneg=full)
    return dict(data=data, left_all=left, right_all=right, has=has,
                starts=starts.reshape(B, R, K), ends=ends.reshape(B, R, K),
                counts=counts.reshape(B, R))


def digitize_window(params, const, t, ch, gain, valid, noise_ix=None, *,
                    n_samples: int, max_intervals: int = 128):
    """Digitize one window on the full digitizer grid (wfsim_tpu's public
    digitize_window, digitize.py:96-178): the grid has
    ``n_channels_total`` rows and carries the noise overlay; on XENONnT
    the HE copies are masked whatever the deamplification factor, on
    XENON1T (no HE block, digitize.py:132) the rows past the TPC are 0.
    wfsim_tpu's ``key`` argument, which it never reads, is dropped.

    :param t: (N,) int32 photon times, ns relative to the window's left
        edge, >= 0
    :param ch/gain/valid: (N,) int32 channels, float32 gains, bool photons
        to keep
    :param noise_ix: int noise-bank start offset (needed with noise on)
    :returns: dict with data (C_all, T) int16, ch_mask/ch_left/ch_right
        (C_all,), zle_starts/zle_ends (C_all, K) relative to ch_left,
        zle_counts (C_all,)
    """
    dev = t.device
    ch = torch.where(valid, ch, -1).to(torch.int32)
    pieces = torch.tensor([[[0, int(t.shape[0]), 0]]], dtype=torch.int64,
                          device=dev)
    nix = (None if noise_ix is None else
           torch.as_tensor(noise_ix, dtype=torch.int32, device=dev).reshape(1))
    out = gather_digitize(params, const, t.to(torch.int32), ch,
                          gain.to(torch.float32), pieces, nix,
                          n_samples=n_samples, max_intervals=max_intervals,
                          full=True)
    return dict(data=out['data'][0], ch_mask=out['has'][0],
                ch_left=out['left_all'][0], ch_right=out['right_all'][0],
                zle_starts=out['starts'][0], zle_ends=out['ends'][0],
                zle_counts=out['counts'][0])


def _record_plan(left_all, starts, ends, counts):
    """Per-interval pulse length, grid-relative start and inclusive record
    cumsum (flattened in (window, channel, interval) order)."""
    spr = SAMPLES_PER_RECORD
    K = starts.shape[2]
    kk = torch.arange(K, device=starts.device, dtype=torch.int32)
    itv_valid = kk[None, None, :] < counts[:, :, None]
    plen = torch.where(itv_valid, ends - starts + 1, 0).to(torch.int32)
    left_rel = (left_all[:, :, None] + starts).to(torch.int32)
    nrec = torch.where(itv_valid,
                       torch.div(plen + spr - 1, spr, rounding_mode='floor'),
                       0)
    csum = torch.cumsum(nrec.reshape(-1), dim=0).to(torch.int32)
    return plen.reshape(-1), left_rel.reshape(-1), csum


def pack_records_ref(data, left_all, starts, ends, counts):
    """Plain twin of the pack_records kernel: (rec_data (R, 110) int16,
    rec_meta (R, 6) int32 rows ``[w, c, start, length, pulse_length,
    record_i]``), the first R rows of wfsim_tpu's pack_records."""
    spr = SAMPLES_PER_RECORD
    B, C, T = data.shape
    K = starts.shape[2]
    dev = data.device
    plen, left_rel, csum = _record_plan(left_all, starts, ends, counts)
    n_rec = int(csum[-1]) if csum.numel() else 0
    r = torch.arange(n_rec, dtype=torch.int32, device=dev)
    itv = torch.clamp_max(torch.searchsorted(csum, r, right=True),
                          csum.numel() - 1)
    base = torch.where(itv > 0, csum[torch.clamp_min(itv - 1, 0)], 0)
    record_i = (r - base).to(torch.int32)
    w_of = (itv // (C * K)).to(torch.int32)
    c_of = ((itv // K) % C).to(torch.int32)
    plen_f = plen[itv]
    start_s = left_rel[itv] + record_i * spr
    length = torch.clamp(plen_f - record_i * spr, 0, spr)
    j = torch.arange(spr, dtype=torch.int64, device=dev)
    col = torch.clamp(start_s.to(torch.int64)[:, None] + j[None, :], 0, T - 1)
    gidx = (w_of.to(torch.int64) * C + c_of)[:, None] * T + col
    rws = data.reshape(-1)[gidx]
    rws = torch.where(j[None, :] < length[:, None], rws, 0).to(torch.int16)
    meta = torch.stack([w_of, c_of, start_s, length, plen_f, record_i],
                       dim=1).to(torch.int32)
    return rws, meta


_kernel = Kernel('wfsim_pack_records', [P, I, I, I, P, P, P, I, I, P, P, P])


def pack_records(data, left_all, starts, ends, counts):
    """ZLE intervals -> strax record rows.  CPU tensors go to
    :func:`pack_records_ref`; CUDA tensors launch the hand-written kernel
    (``csrc/pack_records.cu``) after the record cumsum in torch."""
    B, C, T = data.shape
    K = starts.shape[2]
    dev = data.device
    if data.dtype != torch.int16 or not data.is_contiguous():
        raise TypeError('data must be a contiguous int16 (B, C, T) grid')
    for name, x, shape in (('left_all', left_all, (B, C)),
                           ('starts', starts, (B, C, K)),
                           ('ends', ends, (B, C, K)),
                           ('counts', counts, (B, C))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape \
                or x.device != dev:
            raise TypeError(f'{name}: need int32 {shape} on {dev}, got '
                            f'{x.dtype} {tuple(x.shape)} on {x.device}')
    if dev.type == 'cpu':
        return pack_records_ref(data, left_all, starts, ends, counts)
    if dev.type != 'cuda':
        raise NotImplementedError(f'pack_records on {dev}')
    plen, left_rel, csum = _record_plan(left_all, starts, ends, counts)
    n_rec = int(csum[-1]) if csum.numel() else 0
    rec_data = torch.empty((n_rec, SAMPLES_PER_RECORD), dtype=torch.int16,
                           device=dev)
    rec_meta = torch.empty((n_rec, 6), dtype=torch.int32, device=dev)
    if n_rec == 0:
        return rec_data, rec_meta
    _kernel(ptr(data), T, C, K, ptr(left_rel.contiguous()),
            ptr(plen.contiguous()), ptr(csum), int(csum.numel()), n_rec,
            ptr(rec_data), ptr(rec_meta), stream_of(dev))
    return rec_data, rec_meta
