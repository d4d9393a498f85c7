"""Window digitization: photon arena -> int16 grid -> ZLE -> strax records
(counterpart of wfsim_tpu/pipeline/digitize.py: gather_digitize with its
noise overlay, :183-466, the one-window digitize_window, :96-178, and the
dense pack_records, :469-519; reference: wfsim/core/rawdata.py:204-311,
398-458).

A batch of B windows is one grid of B*C rows (window w, TPC channel c ->
row w*C + c).  The device passes are hand-written kernels with plain
twins: :func:`window_photons` (K17), which gathers each window's photons
from the arena through its piece table in row order with the per-row
extents, ``ops.waveform.superpose_adc`` (or ``superpose_adc_full`` on the
full digitizer grid), ``ops.zle.zle_all_channels``, :func:`pack_records`,
and once a round :func:`round_order`, which orders the round's records as
wfsim_tpu's host ``np.lexsort`` does (rawdata.py:1780), and
:func:`record_rows`, which writes them as strax raw_record rows in their
sorted slots (wfsim_tpu rawdata.py:1790-1816), so one device-to-host copy
gives the final bytes.  The glue left in plain torch is the cumsum of
the rows' record counts.

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

import numpy as np
import torch

from .._build import Kernel, P, I, check_tensor, ptr, scratch, stream_of
from ..ops.waveform import superpose_adc, superpose_adc_full
from ..ops.zle import zle_all_channels

__all__ = ['gather_digitize', 'digitize_window', 'window_photons',
           'window_photons_ref', 'window_rows_plan', 'WINDOW_SEGMENT',
           'full_grid', 'full_grid_rows', 'he_on', 'pack_records',
           'pack_records_ref', 'record_rows', 'record_rows_ref', 'rows_of',
           'round_order', 'round_order_ref', 'round_records',
           'SAMPLES_PER_RECORD',
           'ROW_WORDS16']

SAMPLES_PER_RECORD = 110
#: int16 words of a strax raw_record row (raw_record_dtype(110): 244 bytes)
ROW_WORDS16 = 122


#: photons a block of the window_rows kernel (K17) takes at most: the host
#: cuts each window's photons into segments of this many, in arena order
WINDOW_SEGMENT = 8192
#: consecutive segments of a window that K17's count pass scans as a group
WINDOW_GROUP = 16


def _piece_table(pieces) -> np.ndarray:
    """A batch's piece table as a (B, P, 3) int64 numpy array on the host
    (from numpy or a tensor; a CUDA tensor is read back: pass the host
    table to keep a batch's dispatch free of syncs)."""
    if isinstance(pieces, torch.Tensor):
        pieces = pieces.detach().cpu().numpy()
    p = np.asarray(pieces, dtype=np.int64)
    if p.ndim != 3 or p.shape[2] != 3:
        raise ValueError(f'pieces: need (B, P, 3), got {p.shape}')
    return p


def _check_pieces(p, n_arena: int):
    """Raise unless every piece has a count >= 0 and every piece with
    photons lies inside the arena's ``n_arena`` photons."""
    lo, cnt = p[:, :, 0], p[:, :, 1]
    # a piece with photons outside [0, n_arena), or a negative count
    if ((cnt < 0) | ((cnt > 0) & ((lo < 0) | (lo > n_arena - cnt)))).any():
        raise ValueError(f'pieces: counts must be >= 0 and pieces with '
                         f'photons lie in the arena of {n_arena}')


def window_rows_plan(p, segment: int = WINDOW_SEGMENT):
    """The window_rows kernel's plan of a (B, P, 3) host piece table:
    ``(pstart, plan)``, each piece's first photon within its window (B, P)
    and per segment ``[window, the window's first segment, the window's
    segments, first photon in the window, photons, the window's first
    group]`` (n_seg, 6), int64.  Each window's photons (its pieces' one
    after another) are cut into segments of at most ``segment``; a window
    without photons has one empty segment; every WINDOW_GROUP consecutive
    segments of a window form a group."""
    B = p.shape[0]
    cnt = p[:, :, 1]
    pstart = np.cumsum(cnt, axis=1)
    n_win = pstart[:, -1].copy() if cnt.shape[1] else np.zeros(B, np.int64)
    pstart -= cnt
    n_seg = np.maximum(1, -(-n_win // segment))
    s0 = np.cumsum(n_seg) - n_seg
    n_grp = -(-n_seg // WINDOW_GROUP)
    w = np.repeat(np.arange(B), n_seg)
    j0 = (np.arange(int(n_seg.sum())) - s0[w]) * segment
    plan = np.stack([w, s0[w], n_seg[w], j0,
                     np.minimum(segment, n_win[w] - j0),
                     (np.cumsum(n_grp) - n_grp)[w]], axis=1)
    return pstart, plan.astype(np.int64)


def _i32(x: int) -> int:
    """``x`` modulo 2^32 as a signed int32 (torch's int32 arithmetic)."""
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def window_photons_ref(const, arena_t, arena_ch, arena_gain, pieces, *,
                       n_samples: int):
    """Plain twin of the window_rows kernel (arguments and result as
    :func:`window_photons`), in torch on the arena's device: each row's
    photons gathered and ordered by one stable sort of their rows."""
    dev = arena_t.device
    p = _piece_table(pieces)
    _check_pieces(p, int(arena_t.shape[0]))
    B = p.shape[0]
    T = n_samples
    dt = const.sample_duration
    C = const.n_tpc_pmts
    R = B * C
    n_ph = int(p[:, :, 1].sum())

    pieces = torch.as_tensor(p, device=dev).reshape(-1, 3)
    lo, cnt, toff = pieces[:, 0], pieces[:, 1], pieces[:, 2]
    w_of_piece = torch.arange(B, device=dev).repeat_interleave(
        pieces.shape[0] // max(B, 1))
    first = torch.cumsum(cnt, dim=0) - cnt
    aidx = torch.arange(n_ph, device=dev) + torch.repeat_interleave(
        lo - first, cnt)
    t = (arena_t[aidx].to(torch.int64)
         + torch.repeat_interleave(toff, cnt)).to(torch.int32)
    ch = arena_ch[aidx]
    gain = arena_gain[aidx]
    w = torch.repeat_interleave(w_of_piece, cnt)
    keep = (ch >= 0) & (ch < C)
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
    n_keep = int(order.shape[0])
    t_out = torch.zeros(n_ph, dtype=torch.int32, device=dev)
    gain_out = torch.zeros(n_ph, dtype=torch.float32, device=dev)
    t_out[:n_keep] = t[order]
    gain_out[:n_keep] = gain[order]
    return dict(t=t_out, gain=gain_out, row_ptr=row_ptr, ch_left=ch_left,
                ch_right=ch_right, has=has)


_window_kernel = Kernel('wfsim_window_rows',
                        [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P, P,
                         P])


def window_photons(const, arena_t, arena_ch, arena_gain, pieces, *,
                   n_samples: int):
    """The superposition inputs of a window batch: its photons gathered
    from the arena through the piece table, those with a channel kept, in
    row order (row = window * C + channel; arena order within a row), plus
    each row's extents.

    CPU tensors go to :func:`window_photons_ref`; CUDA tensors launch the
    hand-written kernel (``csrc/window_rows.cu``, K17: a count pass and a
    place pass of a block per segment of up to WINDOW_SEGMENT of a
    window's photons, planned on the host from the piece table), which
    reads nothing back: with the host's piece table and an arena on the
    card, the call does not sync.

    :param arena_t/ch/gain: (A,) int32 / int32 / float32 photon arena;
        times are ns relative to each buffer's base, channel -1 marks a
        photon that was dropped (as does any channel outside [0, C), on
        the card and in the twin alike)
    :param pieces: (B, P, 3) ``[arena_lo, count, t_offset]`` per window
        piece (count 0 marks padding); ``t_offset`` moves a piece's times
        into its window's frame.  A numpy array or a tensor; the card's
        plan is made from it on the host (a CUDA tensor is read back)
    :returns: dict of t, gain, one slot a photon of the table: the kept
        photons in row order on ``[0, row_ptr[-1])``, zeros past them;
        row_ptr (B*C + 1,) int32, ch_left/ch_right (B*C,) int32, has bool
        (on the card, views of one allocation that also holds the
        kernel's tables)
    """
    dev = arena_t.device
    p = _piece_table(pieces)
    if dev.type == 'cpu':
        return window_photons_ref(const, arena_t, arena_ch, arena_gain, p,
                                  n_samples=n_samples)
    if dev.type != 'cuda':
        raise NotImplementedError(f'window_photons on {dev}')
    A = int(arena_t.shape[0])
    for name, x, dtype in (('arena_t', arena_t, torch.int32),
                           ('arena_ch', arena_ch, torch.int32),
                           ('arena_gain', arena_gain, torch.float32)):
        check_tensor(name, x, dtype, (A,), dev)
    _check_pieces(p, A)
    B, n_pieces = p.shape[:2]
    C = const.n_tpc_pmts
    if not 0 < C <= 1024:
        raise ValueError(f'window_photons on the card takes 1 to 1,024 '
                         f'channels a window, not {C}')
    pstart, plan = window_rows_plan(p)
    total = int(plan[:, 4].sum())
    if total >= 2 ** 31:
        raise OverflowError(f'{total} photons in one batch')
    R = B * C
    n_seg = len(plan)
    n_grp = int(plan[-1, 5] + -(-plan[-1, 2] // WINDOW_GROUP)) if B else 0
    # one allocation: the outputs, then the kernel's tables (one split;
    # the kernel takes the allocation's start, which an empty t has not)
    n_tab = 3 * (n_seg + n_grp) * C + R + 2 * B + 1
    work = torch.empty(2 * total + 3 * R + 1 + (R + 3) // 4 + n_tab,
                       dtype=torch.int32, device=dev)
    t, gain, row_ptr, ch_left, ch_right, has, _tables = work.split(
        [total, total, R + 1, R, R, (R + 3) // 4, n_tab])
    out = dict(t=t, gain=gain.view(torch.float32), row_ptr=row_ptr,
               ch_left=ch_left, ch_right=ch_right,
               has=has.view(torch.bool)[:R])
    if B == 0:
        row_ptr.zero_()
        return out
    # the plan to the card in one copy through pinned memory (no sync)
    n_p = B * n_pieces
    host = torch.empty(4 * n_p + plan.size, dtype=torch.int64,
                       pin_memory=True)
    h = host.numpy()
    h[:3 * n_p] = p.reshape(-1)
    h[3 * n_p:4 * n_p] = pstart.reshape(-1)
    h[4 * n_p:] = plan.reshape(-1)
    tab = host.to(dev, non_blocking=True)
    stream = stream_of(dev)
    ctr = scratch(dev, stream, (n_grp + B + 2) // 2)
    left_pad = _i32(const.samples_to_store_before
                    + const.samples_before_pulse_center
                    + const.trigger_window)
    right_pad = _i32(const.samples_to_store_after
                     + const.samples_after_pulse_center
                     + const.trigger_window)
    _window_kernel(ptr(arena_t), ptr(arena_ch), ptr(arena_gain), ptr(tab), B,
                   n_pieces, n_seg, n_grp, C, WINDOW_SEGMENT, n_samples,
                   const.sample_duration, left_pad, right_pad, total,
                   ptr(work), ptr(ctr), stream)
    return out


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
    (arguments as :func:`window_photons`; pass the host piece table, as the
    pipeline does, and a dispatch reads nothing back before the
    superposition).

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
    pieces = np.asarray([[[0, int(t.shape[0]), 0]]], dtype=np.int64)
    nix = (None if noise_ix is None else
           torch.as_tensor(noise_ix, dtype=torch.int32, device=dev).reshape(1))
    out = gather_digitize(params, const, t.to(torch.int32).contiguous(), ch,
                          gain.to(torch.float32).contiguous(), pieces, nix,
                          n_samples=n_samples, max_intervals=max_intervals,
                          full=True)
    return dict(data=out['data'][0], ch_mask=out['has'][0],
                ch_left=out['left_all'][0], ch_right=out['right_all'][0],
                zle_starts=out['starts'][0], zle_ends=out['ends'][0],
                zle_counts=out['counts'][0])


def _record_plan(left_all, starts, ends, counts):
    """Per-interval pulse length, grid-relative start and inclusive record
    cumsum (flattened in (window, channel, interval) order), the twin's
    plan (the kernels plan by row)."""
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


_count_kernel = Kernel('wfsim_pack_record_counts', [P, P, P, I, I, P, P])
_kernel = Kernel('wfsim_pack_records',
                 [P, I, I, I, P, P, P, P, P, I, P, P, P])


def pack_records(data, left_all, starts, ends, counts):
    """ZLE intervals -> strax record rows.  CPU tensors go to
    :func:`pack_records_ref`; CUDA tensors launch the hand-written kernels
    (``csrc/pack_records.cu``): each row's record count, one cumsum over
    the rows, one read-back of the total to size the output, the copy."""
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
    R = B * C
    left_all, starts, ends, counts = (x.contiguous() for x in
                                      (left_all, starts, ends, counts))
    n_rec = 0
    if R and K:
        row_records = torch.empty(R, dtype=torch.int32, device=dev)
        _count_kernel(ptr(starts), ptr(ends), ptr(counts), R, K,
                      ptr(row_records), stream_of(dev))
        row_csum = torch.cumsum(row_records, 0, dtype=torch.int32)
        n_rec = int(row_csum[-1])          # the call's one read-back
    rec_data = torch.empty((n_rec, SAMPLES_PER_RECORD), dtype=torch.int16,
                           device=dev)
    rec_meta = torch.empty((n_rec, 6), dtype=torch.int32, device=dev)
    if n_rec == 0:
        return rec_data, rec_meta
    _kernel(ptr(data), T, C, K, ptr(left_all), ptr(starts), ptr(ends),
            ptr(counts), ptr(row_csum), R, ptr(rec_data), ptr(rec_meta),
            stream_of(dev))
    return rec_data, rec_meta


def rows_of(data, meta, win, win_left, dt: int):
    """Records as (N, 122) int16 raw_record rows in their given order
    (the rows the record_rows kernel writes, before any permutation)."""
    n = int(data.shape[0])
    if n == 0:
        return torch.empty((0, ROW_WORDS16), dtype=torch.int16,
                           device=data.device)

    def words(x):
        return x.contiguous().view(torch.int16).reshape(n, -1)
    t = (win_left[win.to(torch.int64)] + meta[:, 2].to(torch.int64)) * dt
    return torch.cat([
        words(t), words(meta[:, 3]),
        torch.full((n, 1), dt, dtype=torch.int16, device=data.device),
        meta[:, 1:2].to(torch.int16), words(meta[:, 4]),
        meta[:, 5:6].to(torch.int16),
        torch.zeros((n, 1), dtype=torch.int16, device=data.device),
        data], dim=1)


def _batches(x):
    """A round's records of one kind as a list of per-batch tensors."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def record_rows_ref(data, meta, win, win_left, perm, dt: int):
    """Plain twin of the record_rows kernel: (N, 122) int16 rows, row i
    the raw_record_dtype(110) bytes of record ``perm[i]``: time
    ``(win_left[win[r]] + start) * dt`` (int64), length, dt, channel,
    pulse_length, record_i, baseline 0, the samples (``data`` and
    ``meta`` as :func:`record_rows` takes them)."""
    data, meta = (torch.cat(_batches(x)) for x in (data, meta))
    return rows_of(data[perm], meta[perm], win[perm], win_left, dt)


_rows_kernel = Kernel('wfsim_record_rows', [P, I, P, P, P, I, I, P, P])


def _row_table(data, meta):
    """K4r's batch table as an int64 numpy array: the batches' first
    records (and the total), then their rec_data and rec_meta pointers."""
    n = [int(d.shape[0]) for d in data]
    return np.concatenate([[0], np.cumsum(n), [ptr(d) for d in data],
                           [ptr(m) for m in meta]]).astype(np.int64)


def _to_card(arr, dev):
    """A host int64 array on the card through pinned memory (no sync)."""
    host = torch.empty(len(arr), dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = arr
    return host.to(dev, non_blocking=True)


def record_rows(data, meta, win, win_left, perm, dt: int):
    """A round's records as strax raw_record rows in the order ``perm``
    (K4r).  CPU tensors go to :func:`record_rows_ref`; CUDA tensors launch
    ``wfsim_record_rows`` (``csrc/pack_records.cu``), which reads the
    batches where they lie (no concatenation) and reads nothing back.

    :param data/meta: :func:`pack_records`' (n_j, 110) int16 and (n_j, 6)
        int32 outputs of the round's batches, each a list in the round's
        order or one tensor; record r is row r of their concatenation
    :param win: (N,) int32 each record's window in the round
    :param win_left: (W,) int64 each window's left edge (samples)
    :param perm: (N,) int64 the record of each output row
    :returns: (N, 122) int16, the rows' bytes
    """
    data, meta = _batches(data), _batches(meta)
    n = int(perm.shape[0])
    dev = perm.device
    if len(data) != len(meta):
        raise ValueError(f'{len(data)} rec_data but {len(meta)} rec_meta')
    for d, m in zip(data, meta):
        k = int(d.shape[0])
        check_tensor('data', d, torch.int16, (k, SAMPLES_PER_RECORD), dev)
        check_tensor('meta', m, torch.int32, (k, 6), dev)
    for name, x, dtype, shape in (
            ('win', win, torch.int32, (n,)),
            ('win_left', win_left, torch.int64, tuple(win_left.shape[:1])),
            ('perm', perm, torch.int64, (n,))):
        check_tensor(name, x, dtype, shape, dev)
    if sum(int(d.shape[0]) for d in data) != n:
        raise ValueError(f'perm has {n} entries for '
                         f'{sum(int(d.shape[0]) for d in data)} records')
    if dev.type == 'cpu':
        return record_rows_ref(data, meta, win, win_left, perm, dt)
    if dev.type != 'cuda':
        raise NotImplementedError(f'record_rows on {dev}')
    out = torch.empty((n, ROW_WORDS16), dtype=torch.int16, device=dev)
    if n:
        if any(ptr(d) % 4 or ptr(m) % 8 for d, m in zip(data, meta)
               if d.shape[0]):
            raise ValueError('record_rows: rec_data must be 4-byte and '
                             'rec_meta 8-byte aligned')
        table = _to_card(_row_table(data, meta), dev)
        _rows_kernel(ptr(table), len(data), ptr(win), ptr(win_left),
                     ptr(perm), n, int(dt), ptr(out), stream_of(dev))
    return out


def _key_bits(n_win: int, n_samples: int, n_rows: int):
    """The bits of a round's packed keys' (window, start, channel) fields,
    each from its bound; a round whose keys do not fit 63 bits raises."""
    bits_c = max(int(n_rows - 1).bit_length(), 1)
    bits_s = max(int(n_samples - 1).bit_length(), 1)
    bits_w = max(int(n_win - 1).bit_length(), 1)
    if bits_w + bits_s + bits_c > 63:
        raise OverflowError(f'record keys of {n_win} windows x {n_samples} '
                            f'samples x {n_rows} rows need '
                            f'{bits_w + bits_s + bits_c} bits')
    return bits_w, bits_s, bits_c


def round_order_ref(parts, win_left, *, n_samples: int, n_rows: int):
    """Plain twin of :func:`round_order` (same arguments; ``parts`` is
    emptied): the round's records concatenated, their windows, and one
    stable sort of packed (window, start, channel) keys on the records'
    device; the windows' counts by a search of the sorted keys.  Returns
    :func:`round_order`'s dict plus the sorted keys ``key`` and ``shift``,
    the bits below a key's window field."""
    dev = parts[0][1].device
    n_win = len(win_left)
    _bits_w, bits_s, bits_c = _key_bits(n_win, n_samples, n_rows)
    # the windows' left edges and each batch's window ids go to the
    # device in one copy (pinned on the card: no sync)
    host = np.concatenate([np.asarray(win_left, np.int64)]
                          + [np.asarray(b, np.int64) for b, _, _ in parts])
    host = (_to_card(host, dev) if dev.type == 'cuda'
            else torch.from_numpy(host))
    first = np.cumsum([n_win] + [len(b) for b, _, _ in parts])
    data = torch.cat([d for _, d, _ in parts])
    meta = torch.cat([m for _, _, m in parts])
    win = torch.cat([host[int(o) + m[:, 0].to(torch.int64)]
                     for o, (_, _, m) in zip(first, parts)]).to(torch.int32)
    parts.clear()
    shift = bits_s + bits_c
    key = ((win.to(torch.int64) << shift)
           | (meta[:, 2].to(torch.int64) << bits_c)
           | meta[:, 1].to(torch.int64))
    key, perm = torch.sort(key, stable=True)
    bounds = torch.searchsorted(key, torch.arange(
        n_win + 1, device=dev) << shift)
    return dict(data=data, meta=meta, win=win, win_left=host[:n_win],
                perm=perm, counts=bounds[1:] - bounds[:-1], key=key,
                shift=shift)


_order_kernel = Kernel('wfsim_round_order', [P, I, I, I, I, P, P, P, P, P])


def round_order(parts, win_left, *, n_samples: int, n_rows: int):
    """The record_rows inputs of one digitize round: its records in the
    (window, start, channel) order of wfsim_tpu's ``np.lexsort((C, S,
    W))`` (rawdata.py:1780), stable over the batches in turn, and each
    window's record count.

    CPU tensors go to :func:`round_order_ref` (one sort of packed keys);
    CUDA tensors launch ``wfsim_round_order`` (``csrc/round_order.cu``: the
    windows' counts by a search of each batch's window column, then a
    block a window ranking its records by (start, channel), and a block
    for each further 4,096 records of a longer window), which reads
    nothing back and leaves the batches' records where they lie.

    :param parts: list of per digitize batch ``(window ids, rec_data,
        rec_meta)``: the round's window of each batch window (a host int
        array; every round window in one batch) and :func:`pack_records`'
        outputs; emptied, so that the caller does not hold the batches'
        outputs beside the round's rows
    :param win_left: (W,) int64 host array of the windows' left edges
    :param n_samples: the round's largest window length: every record
        starts below it
    :param n_rows: the grid rows a window (records' channels lie below)
    :returns: dict of data, meta (lists of the batches' tensors on the
        card, concatenated on the CPU), win (N,) int32 each record's
        window, win_left (W,) int64, perm (N,) int64 (record_rows'
        arguments) and counts (W,) int64 each window's records
    """
    dev = parts[0][1].device
    if dev.type == 'cpu':
        return round_order_ref(parts, win_left, n_samples=n_samples,
                               n_rows=n_rows)
    if dev.type != 'cuda':
        raise NotImplementedError(f'round_order on {dev}')
    n_win = len(win_left)
    _bits_w, bits_s, bits_c = _key_bits(n_win, n_samples, n_rows)
    if bits_s + bits_c > 32:
        raise OverflowError(f'round_order on the card keys (start, channel) '
                            f'in 32 bits: {n_samples} samples x {n_rows} '
                            f'rows need {bits_s + bits_c}')
    ids = [np.asarray(b, np.int64) for b, _, _ in parts]
    wids = np.concatenate(ids)
    if not np.array_equal(np.sort(wids), np.arange(n_win)):
        raise ValueError(f'the batches\' windows must be each of the '
                         f'{n_win} round windows once')
    data = [d for _, d, _ in parts]
    meta = [m for _, _, m in parts]
    parts.clear()
    for d, m in zip(data, meta):
        k = int(d.shape[0])
        check_tensor('rec_data', d, torch.int16, (k, SAMPLES_PER_RECORD), dev)
        check_tensor('rec_meta', m, torch.int32, (k, 6), dev)
    n_b = len(data)
    n_rec = [int(d.shape[0]) for d in data]
    first = np.concatenate([[0], np.cumsum(n_rec)])
    N = int(first[-1])
    if N >= 2 ** 31:
        raise OverflowError(f'{N} records in one round')
    # one copy to the card: win_left, the ordering's table (per batch
    # [rec_data, rec_meta, first record, records], each batch's first
    # window entry, the entries' round windows)
    bt = np.stack([[ptr(d) for d in data], [ptr(m) for m in meta],
                   first[:-1], n_rec], axis=1).reshape(-1)
    qoff = np.concatenate([[0], np.cumsum([len(b) for b in ids])])
    tab = _to_card(np.concatenate([np.asarray(win_left, np.int64), bt, qoff,
                                   wids]), dev)
    # one allocation: the counts, the kernel's tables, perm, win
    n_work = 8 * n_win + 2
    work = torch.empty(n_work + N + (N + 1) // 2, dtype=torch.int64,
                       device=dev)
    perm = work[n_work:n_work + N]
    win = work[n_work + N:].view(torch.int32)[:N]
    stream = stream_of(dev)
    _order_kernel(ptr(tab[n_win:]), n_b, n_win, bits_c, N, ptr(work),
                  ptr(perm), ptr(win), ptr(scratch(dev, stream, 1)), stream)
    return dict(data=data, meta=meta, win=win, win_left=tab[:n_win],
                perm=perm, counts=work[:n_win])


def round_records(parts, win_left, *, dt: int, n_samples: int, n_rows: int):
    """One digitize round's records as strax raw_record rows, time-sorted
    (:func:`round_order`, then :func:`record_rows`; ``parts`` is emptied).

    :returns: ``(rows, counts)``: the (N, 122) int16 rows on the device
        and each window's record count (a (W,) int64 numpy array; the
        round's one read-back)
    """
    o = round_order(parts, win_left, n_samples=n_samples, n_rows=n_rows)
    rows = record_rows(o.pop('data'), o.pop('meta'), o['win'], o['win_left'],
                       o['perm'], dt)
    return rows, o['counts'].cpu().numpy().astype(np.int64)
