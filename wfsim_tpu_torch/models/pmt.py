"""PMT response: transit-time spread, double-PE emission, SPE gain and the
truth counters (counterpart of wfsim_tpu/models/pmt.py; reference:
wfsim/core/pulse.py:39-144, 229-271).

The stage is a pure function of explicit draws (``pmt_draws``), so the
tests can hand both packages the same normals and uniforms.  CPU tensors
run the plain twins (``photon_pass_ref``, ``pulse_truth_ref``,
``photon_time_stats_ref``, ``pulse_truth_per_pmt_ref``); CUDA tensors
launch the entry points of ``csrc/pmt_response.cu``: the photon pass, the
row kernel (truth sums and time statistics) and, with ``per_pmt_truth``,
the per-PMT kernel.  Each truth kernel sums a row's first chunk of
elements and each tile of the batch past its rows' first chunks as one
piece (a warp's or a block's, :func:`row_truth_layout`), a longer row's
pieces combined by integer atomics; both sum exact integers (the areas in
fixed point), so their outputs have the same bits run to run, and neither
reads anything back.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import (Kernel, P, I, F, check_tensor, ptr, scratch,
                      stream_of)
from .common import trunc_int
from ..ops.randsample import uniform, normal
from ..ops.segment import sorted_segment_sum, segment_min_max, expand_rows

__all__ = ['pmt_draws', 'pmt_response', 'photon_time_stats',
           'pulse_truth_per_pmt', 'photon_pass_ref', 'pulse_truth_ref',
           'photon_time_stats_ref', 'pulse_truth_per_pmt_ref', 'TRUTH_SUMS',
           'PER_PMT_SUMS']

_SUMS = ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger', 'raw_area',
         'raw_area_trigger')
#: the per-row truth sums, in the row kernel's output order
TRUTH_SUMS = tuple(name + suffix for suffix in ('', '_bottom')
                   for name in _SUMS)
#: the per-(row, channel) truth sums: four int32 counts, two float64 areas
PER_PMT_SUMS = tuple(name + '_per_pmt' for name in _SUMS)

_pass_kernel = Kernel('wfsim_pmt_photon_pass',
                      [I, P, P, P, P, P, P, P, P, I, P, I, F, F, F, P, P, P,
                       P, P, P])
_row_kernel = Kernel('wfsim_pmt_row_truth',
                     [P, I, I, I, I, P, P, P, P, P, P, I, P, I, F, I, P, P,
                      P, P, P, P, P, P, P])
_per_pmt_kernel = Kernel('wfsim_pmt_row_truth_per_pmt',
                         [P, I, I, I, P, P, P, P, P, P, I, P, I, F, I, P, P,
                          P, P, P])
#: the row kernel keeps three channel columns (12 bytes a channel) and the
#: per-PMT kernel its sums (24 bytes a channel) in a block's shared memory
MAX_PER_PMT_CHANNELS = 1536
#: photons a block of the per-PMT kernel accumulates (a row's first chunk,
#: or a tile of a longer row); its packed 16-bit counts take up to 16,383
PER_PMT_CHUNK = 8192
#: the truth kernels keep raw areas as int64 multiples of 2^-AREA_SCALE
#: (handed to both, 1 to 61): exact for terms of at least
#: 2^(23 - AREA_SCALE) and row sums up to 2^(62 - AREA_SCALE) (the
#: synthetic SPE tables' terms lie in [0.068, 6])
AREA_SCALE = 32
_ROW_ACC_WORDS = 17          # the row kernel's accumulator a row (int64)
_SECOND_PASS: dict = {}


def row_truth_layout(n: int, n_rows: int):
    """(block_rows, chunk) of the row kernel for a batch of ``n`` elements
    in ``n_rows`` rows.  A row's first ``chunk`` elements are summed by one
    warp (``block_rows`` False: rows of a mean below 512, such as S1
    photons and S2 electrons) or one block (a mean of 512 or more, such as
    S2 photons), and each tile of ``chunk`` elements past its rows' first
    chunks by another; a longer row's pieces are combined by atomics.  A
    warp's chunk is the smallest power of two from 32 to 1,024 no shorter
    than twice the mean row and giving at most 2,048 tiles; a block's is
    8,192."""
    if n >= 512 * max(n_rows, 1):
        return True, 8192
    w = 32
    while w < 1024 and (w * n_rows < 2 * n or w * 2048 < n):
        w *= 2
    return False, w


def pmt_truth_second_pass(device):
    """The (3,) int32 counts, on ``device``, of the rows the truth kernels
    summed in their float64 second pass since the counts were made or last
    zeroed: the row kernel's rows outside the int64 moment range, its rows
    outside the fixed-point area range, and the per-PMT kernel's rows
    outside that range (see :func:`row_truth_second_pass_ref`).  The
    kernels add to it; no wrapper reads it back."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    if device not in _SECOND_PASS:
        _SECOND_PASS[device] = torch.zeros(3, dtype=torch.int32,
                                           device=device)
    return _SECOND_PASS[device]


def pmt_draws(gen, n: int, device) -> dict:
    """The per-photon draws of :func:`pmt_response`: a TTS normal, a DPE
    uniform and two SPE-gain uniforms."""
    return dict(tts=normal(gen, n, device), dpe=uniform(gen, n, device),
                u1=uniform(gen, n, device), u2=uniform(gen, n, device))


# ---------------------------------------------------------------------------
# plain twins


def photon_pass_ref(params, const, t, ch, valid, truth_row, draws) -> dict:
    """Plain twin of the photon pass: TTS, DPE flag, SPE gain, live mask."""
    n_ch = params.gains.shape[0]
    chc = torch.clamp(ch, 0, n_ch - 1).to(torch.int64)
    cp = params.chan_pack[chc]
    gain_ch = cp[:, 0]
    tts = draws['tts'] * (const.pmt_transit_time_spread / 2.35482) \
        + const.pmt_transit_time_mean
    t = t + trunc_int(tts)
    is_dpe = draws['dpe'] < const.p_double_pe_emision
    idx1 = (draws['u1'] * 2000).to(torch.int64) + 1
    idx2 = (draws['u2'] * 2000).to(torch.int64) + 1
    ut = params.uniform_to_pe
    g1 = gain_ch * ut[chc, idx1]
    g2 = gain_ch * ut[chc, idx2]
    gain = g1 + torch.where(is_dpe, g2, 0.0)

    # photons on turned-off PMTs are dropped (reference: pulse.py:89)
    valid = valid & (ch >= 0) & (ch < n_ch) & (cp[:, 2] > 0)
    return dict(t=t, ch=torch.where(valid, ch, -1), gain=gain,
                is_dpe=is_dpe, valid=valid, truth_row=truth_row)


def _truth_terms(params, const, ph):
    """Per photon: the six truth terms in :data:`_SUMS` order (float32, 0
    where invalid), the clamped channel and the bottom-array mask.  The
    trigger test compares the photon's peak amplitude in ADC with the
    channel threshold."""
    t, ch, gain, valid = ph['t'], ph['ch'], ph['gain'], ph['valid']
    chc = torch.clamp(ch, 0, params.gains.shape[0] - 1).to(torch.int64)
    cp = params.chan_pack[chc]
    dt = const.sample_duration
    remainder = torch.remainder(t, dt).to(torch.int64)
    cm = params.current_max[remainder]
    max_amp_adc = gain * cm * const.current_2_adc
    above = valid & (max_amp_adc > cp[:, 1])
    is_dpe = ph['is_dpe'] & valid

    v1 = valid.to(torch.float32)
    pe_w = v1 + is_dpe.to(torch.float32)
    trig = above.to(torch.float32)
    pe_trig = trig + (above & is_dpe).to(torch.float32)
    gain_over_g = torch.where(valid, gain / torch.clamp_min(cp[:, 0], 1e-30),
                              0.0)
    area_trig = torch.where(above, gain_over_g, 0.0)
    bot = (cp[:, 3] > 0) & valid
    return (v1, pe_w, trig, pe_trig, gain_over_g, area_trig), chc, bot


def pulse_truth_ref(params, const, ph, row_edges) -> dict:
    """Truth counters per row (reference: wfsim/core/pulse.py:229-271).
    Sums are float64 (exact for the counts)."""
    terms, _chc, bot = _truth_terms(params, const, ph)
    out = {}
    for suffix, mask in (('', ph['valid']), ('_bottom', bot)):
        for name, x in zip(_SUMS, terms):
            out[name + suffix] = sorted_segment_sum(x, row_edges, valid=mask)
    return out


def per_pmt_inputs(params, const, ph, row_edges):
    """The flat (row * C + channel) index and the (n, 6) float64 terms of
    the valid photons inside the rows: what the per-PMT sums scatter-add
    into an (R * C, 6) table (the twin's one ``index_add_``)."""
    terms, chc, _bot = _truth_terms(params, const, ph)
    C = params.gains.shape[0]
    R = row_edges.shape[0] - 1
    lo, hi = int(row_edges[0]), int(row_edges[-1])
    row = torch.repeat_interleave(
        torch.arange(R, device=chc.device),
        (row_edges[1:] - row_edges[:-1]).to(torch.int64), output_size=hi - lo)
    sel = ph['valid'][lo:hi]
    idx = (row * C + chc[lo:hi])[sel]
    x = torch.stack([v[lo:hi][sel] for v in terms], dim=1).to(torch.float64)
    return idx, x


def pulse_truth_per_pmt_ref(params, const, ph, row_edges) -> dict:
    """Per-PMT truth (wfsim_tpu/models/pmt.py:146-154): the six sums of
    :data:`PER_PMT_SUMS` per (truth row, channel), each (R, C) with C =
    ``params.gains.shape[0]``; counts int32, areas float64.  One float64
    ``index_add_`` of the valid photons' terms at ``row * C + channel``
    (wfsim_tpu sends invalid photons to (0, 0) with a value of 0: the same
    sums)."""
    C = params.gains.shape[0]
    R = row_edges.shape[0] - 1
    idx, x = per_pmt_inputs(params, const, ph, row_edges)
    acc = torch.zeros((R * C, len(_SUMS)), dtype=torch.float64,
                      device=x.device).index_add_(0, idx, x)
    acc = acc.reshape(R, C, len(_SUMS))
    return {name: (acc[..., k].to(torch.int32) if k < 4
                   else acc[..., k].contiguous())
            for k, name in enumerate(PER_PMT_SUMS)}


def photon_time_stats_ref(t, valid, truth_row, n_truth_rows: int, row_edges):
    """Plain twin of :func:`photon_time_stats`."""
    if valid is None:
        valid = torch.ones_like(t, dtype=torch.bool)
    tmin, tmax = segment_min_max(t, truth_row, n_truth_rows, valid=valid)
    cnt = sorted_segment_sum(valid, row_edges).to(torch.int64)
    tmin_ph = expand_rows(torch.where(cnt > 0, tmin, 0),
                          row_edges[1:] - row_edges[:-1])
    centered = (t - tmin_ph).to(torch.float64)
    s1_ = sorted_segment_sum(centered, row_edges, valid=valid)
    s2_ = sorted_segment_sum(centered * centered, row_edges, valid=valid)
    cntf = torch.clamp_min(cnt.to(torch.float64), 1.0)
    mean_c = s1_ / cntf
    var = torch.clamp_min(s2_ / cntf - mean_c * mean_c, 0.0)
    return dict(count=cnt, t_min=tmin, t_max=tmax, t_mean_offset=mean_c,
                t_sigma=torch.sqrt(var))


def row_truth_second_pass_ref(params, const, t, valid, row_edges, ph=None):
    """(moments, areas): (R,) bool each, the rows the truth kernels sum in
    their float64 second pass.  ``moments``: count x (t_max - t_min)^2 of
    the row's valid times is at least 2^62 (its min-centred second moment
    may not fit the int64 sums).  ``areas`` (with photons ``ph``, else all
    False): a valid nonzero raw-area term is below 2^(23 - AREA_SCALE) in
    magnitude, or count x the largest (in float64) is above
    2^(62 - AREA_SCALE), or a term is not finite (the fixed-point sums could
    be inexact).  The per-PMT kernel's rows are the ``areas`` rows."""
    n = t.shape[0]
    R = row_edges.shape[0] - 1
    v = (torch.ones(n, dtype=torch.bool, device=t.device) if valid is None
         else valid)
    row = torch.repeat_interleave(
        torch.arange(R, device=t.device), row_edges[1:] - row_edges[:-1],
        output_size=int(row_edges[-1] - row_edges[0]))
    lo, hi = int(row_edges[0]), int(row_edges[-1])
    sel = v[lo:hi]
    tmin, tmax = segment_min_max(t[lo:hi], row, R, valid=sel)
    cnt = sorted_segment_sum(v, row_edges).to(torch.int64)
    moments = torch.tensor([
        c > 0 and c * (b - a) ** 2 >= 2 ** 62 for c, a, b in zip(
            cnt.tolist(), tmin.tolist(), tmax.tolist())],
        dtype=torch.bool, device=t.device)
    areas = torch.zeros(R, dtype=torch.bool, device=t.device)
    if ph is not None:
        terms, _chc, _bot = _truth_terms(params, const, ph)
        x = terms[4][lo:hi].abs()
        nz = sel & (x != 0)
        big = torch.full((R,), -1.0, dtype=torch.float64, device=t.device)
        big.scatter_reduce_(0, row[nz], x[nz].to(torch.float64), 'amax')
        small = torch.full((R,), float('inf'), dtype=torch.float64,
                           device=t.device)
        small.scatter_reduce_(0, row[nz], x[nz].to(torch.float64), 'amin')
        bad = torch.zeros(R, dtype=torch.bool, device=t.device)
        bad.index_fill_(0, row[nz & ~torch.isfinite(x)], True)
        areas = (big >= 0) & (bad | (small < 2.0 ** (23 - AREA_SCALE))
                              | (cnt.to(torch.float64) * big
                                 > 2.0 ** (62 - AREA_SCALE)))
    return moments, areas


# ---------------------------------------------------------------------------
# kernels


def _photon_pass(params, const, t, ch, valid, truth_row, draws) -> dict:
    dev = t.device
    n = t.shape[0]
    C, M = params.uniform_to_pe.shape
    for name, x, dtype in (('t', t, torch.int32), ('ch', ch, torch.int32),
                           ('valid', valid, torch.bool),
                           ('truth_row', truth_row, torch.int64),
                           *((k, draws[k], torch.float32)
                             for k in ('tts', 'dpe', 'u1', 'u2'))):
        check_tensor(name, x, dtype, (n,), dev)
    check_tensor('chan_pack', params.chan_pack, torch.float32, (C, 4), dev)
    check_tensor('uniform_to_pe', params.uniform_to_pe, torch.float32,
                 (C, M), dev)
    if M < 2001:
        raise ValueError(f'uniform_to_pe has {M} < 2001 columns')
    if dev.type == 'cpu':
        return photon_pass_ref(params, const, t, ch, valid, truth_row, draws)
    if dev.type != 'cuda':
        raise NotImplementedError(f'pmt_response on {dev}')
    out = dict(t=torch.empty_like(t), ch=torch.empty_like(ch),
               gain=torch.empty(n, dtype=torch.float32, device=dev),
               is_dpe=torch.empty(n, dtype=torch.bool, device=dev),
               valid=torch.empty(n, dtype=torch.bool, device=dev),
               truth_row=truth_row)
    if n:
        _pass_kernel(n, ptr(t), ptr(ch), ptr(valid), ptr(draws['tts']),
                     ptr(draws['dpe']), ptr(draws['u1']), ptr(draws['u2']),
                     ptr(params.chan_pack), C, ptr(params.uniform_to_pe), M,
                     float(np.float32(const.pmt_transit_time_spread
                                      / 2.35482)),
                     float(np.float32(const.pmt_transit_time_mean)),
                     float(np.float32(const.p_double_pe_emision)),
                     ptr(out['t']), ptr(out['ch']), ptr(out['gain']),
                     ptr(out['is_dpe']), ptr(out['valid']), stream_of(dev))
    return out


def _aligned(x):
    """``x`` (None passes), or where its data does not start on a 16-byte
    boundary (a view into another tensor) a copy that does: the truth
    kernels load four photons' fields, and a channel's row of
    ``chan_pack``, as 16-byte words."""
    return x if x is None or x.data_ptr() % 16 == 0 else x.clone()


def _check_edges(row_edges, n: int):
    """The CPU paths' check that the rows lie inside the ``n`` elements
    (on the card the kernels clamp the edges to ``n`` instead: no
    read-back)."""
    if row_edges.shape[0] > 1 and int(row_edges[-1]) > n:
        raise ValueError(f'row edges reach past the {n} elements')


def _row_truth(params, const, t, valid, row_edges, ph=None) -> dict:
    """The row kernel: time statistics of ``t`` (all valid where ``valid``
    is None) per row, and with the photons ``ph`` the truth sums too.  Rows
    are clamped to the ``n`` elements; nothing is read back."""
    dev = t.device
    n = t.shape[0]
    R = row_edges.shape[0] - 1
    check_tensor('t', t, torch.int32, (n,), dev)
    check_tensor('row_edges', row_edges, torch.int64, (R + 1,), dev)
    if valid is not None:
        check_tensor('valid', valid, torch.bool, (n,), dev)
    t, valid = _aligned(t), _aligned(valid)
    truth_args = (None, None, None, None, 0, None, 0, 0.0)
    sums = None
    if ph is not None:
        C = params.chan_pack.shape[0]
        dt = const.sample_duration
        check_tensor('ch', ph['ch'], torch.int32, (n,), dev)
        check_tensor('gain', ph['gain'], torch.float32, (n,), dev)
        check_tensor('is_dpe', ph['is_dpe'], torch.bool, (n,), dev)
        check_tensor('chan_pack', params.chan_pack, torch.float32, (C, 4),
                     dev)
        check_tensor('current_max', params.current_max, torch.float32,
                     (dt,), dev)
        if not 0 < C <= MAX_PER_PMT_CHANNELS:
            raise ValueError(f'truth sums of {C} channels: the kernel takes '
                             f'1 to {MAX_PER_PMT_CHANNELS}')
        truth_args = (*(ptr(_aligned(ph[k])) for k in ('ch', 'gain',
                                                       'is_dpe')),
                      ptr(params.chan_pack), C, ptr(params.current_max), dt,
                      float(np.float32(const.current_2_adc)))
        # every entry is written by the kernel
        sums = torch.empty((len(TRUTH_SUMS), R), dtype=torch.float64,
                           device=dev)
    out = dict(count=torch.empty(R, dtype=torch.int64, device=dev),
               t_min=torch.empty(R, dtype=torch.int32, device=dev),
               t_max=torch.empty(R, dtype=torch.int32, device=dev),
               t_mean_offset=torch.empty(R, dtype=torch.float64, device=dev),
               t_sigma=torch.empty(R, dtype=torch.float64, device=dev))
    if R:
        stream = stream_of(dev)
        acc = scratch(dev, stream, R * _ROW_ACC_WORDS)
        block_rows, chunk = row_truth_layout(n, R)
        _row_kernel(ptr(row_edges), R, n, chunk.bit_length() - 1,
                    int(block_rows), ptr(t),
                    None if valid is None else ptr(valid), *truth_args,
                    AREA_SCALE, None if sums is None else ptr(sums),
                    ptr(out['count']),
                    ptr(out['t_min']), ptr(out['t_max']),
                    ptr(out['t_mean_offset']), ptr(out['t_sigma']),
                    ptr(acc), ptr(pmt_truth_second_pass(dev)), stream)
    if ph is not None:
        out.update(zip(TRUTH_SUMS, sums))
    return out


def _row_truth_per_pmt(params, const, ph, row_edges) -> dict:
    """The per-PMT kernel (see :func:`pulse_truth_per_pmt`): a block per
    row's first :data:`PER_PMT_CHUNK` photons and per tile of that many
    photons of the batch; rows clamped to the photons, nothing read
    back."""
    dev = ph['t'].device
    n = ph['t'].shape[0]
    R = row_edges.shape[0] - 1
    C = params.chan_pack.shape[0]
    dt = const.sample_duration
    for name, dtype in (('t', torch.int32), ('ch', torch.int32),
                        ('gain', torch.float32), ('is_dpe', torch.bool),
                        ('valid', torch.bool)):
        check_tensor(name, ph[name], dtype, (n,), dev)
    check_tensor('row_edges', row_edges, torch.int64, (R + 1,), dev)
    check_tensor('chan_pack', params.chan_pack, torch.float32, (C, 4), dev)
    check_tensor('current_max', params.current_max, torch.float32, (dt,),
                 dev)
    if not 0 < C <= MAX_PER_PMT_CHANNELS:
        raise ValueError(f'per-PMT truth of {C} channels: the kernel takes '
                         f'1 to {MAX_PER_PMT_CHANNELS}')
    counts = torch.empty((4, R, C), dtype=torch.int32, device=dev)
    areas = torch.empty((2, R, C), dtype=torch.float64, device=dev)
    if R:
        tiles = -(-n // PER_PMT_CHUNK)
        stream = stream_of(dev)
        table = scratch(dev, stream, tiles * (4 * C + 2))
        _per_pmt_kernel(ptr(row_edges), R, n, PER_PMT_CHUNK,
                        *(ptr(_aligned(ph[k])) for k in (
                            't', 'valid', 'ch', 'gain', 'is_dpe')),
                        ptr(_aligned(params.chan_pack)), C,
                        ptr(params.current_max), dt,
                        float(np.float32(const.current_2_adc)), AREA_SCALE,
                        ptr(counts), ptr(areas), ptr(table),
                        ptr(pmt_truth_second_pass(dev)), stream)
    return dict(zip(PER_PMT_SUMS, (*counts, *areas)))


def pulse_truth_per_pmt(params, const, ph, row_edges) -> dict:
    """Per-PMT truth of a photon batch from :func:`pmt_response`'s photon
    pass: the six sums of :data:`PER_PMT_SUMS`, each (R, C) with C =
    ``params.gains.shape[0]`` (counts int32, raw areas float64).  CPU
    tensors run :func:`pulse_truth_per_pmt_ref`; CUDA tensors the per-PMT
    kernel of ``csrc/pmt_response.cu``: counts equal to the twin's, areas
    the exact sums of their terms (the twin's bits wherever its own float64
    sums are exact, else within rtol 1e-12), the same bits run to run."""
    dev = ph['t'].device
    if dev.type == 'cpu':
        _check_edges(row_edges, ph['t'].shape[0])
        return pulse_truth_per_pmt_ref(params, const, ph, row_edges)
    if dev.type != 'cuda':
        raise NotImplementedError(f'pulse_truth_per_pmt on {dev}')
    return _row_truth_per_pmt(params, const, ph, row_edges)


# ---------------------------------------------------------------------------
# the stage


def pmt_response(params, const, t, ch, valid, truth_row, draws, *,
                 n_truth_rows: int, row_edges):
    """Apply the PMT response to a photon batch.

    :param t: (N,) int32 photon times (batch-relative ns)
    :param ch: (N,) int32 channels (-1 where no channel was drawn)
    :param valid: (N,) bool
    :param truth_row: (N,) int64 truth row per photon, ascending
    :param draws: dict from :func:`pmt_draws`
    :param row_edges: (n_truth_rows + 1,) int64 photon boundaries of the
        rows
    :returns: (photons dict, truth dict): the truth sums of
        :data:`TRUTH_SUMS` and the photon time statistics as
        ``photon_count``, ``photon_t_min``, ... (:func:`photon_time_stats`);
        with ``const.per_pmt_truth`` the sums of :data:`PER_PMT_SUMS` take
        the place of the ``*_bottom`` ones, as in wfsim_tpu
    """
    photons = _photon_pass(params, const, t, ch, valid, truth_row, draws)
    if t.device.type == 'cpu':
        _check_edges(row_edges, t.shape[0])
        truth = pulse_truth_ref(params, const, photons, row_edges)
        stats = photon_time_stats_ref(photons['t'], photons['valid'],
                                      truth_row, n_truth_rows, row_edges)
    else:
        stats = _row_truth(params, const, photons['t'], photons['valid'],
                           row_edges, ph=photons)
        truth = {k: stats.pop(k) for k in TRUTH_SUMS}
    truth.update({'photon_' + k: v for k, v in stats.items()})
    if const.per_pmt_truth:
        for k in TRUTH_SUMS[len(_SUMS):]:
            del truth[k]
        truth.update(pulse_truth_per_pmt(params, const, photons, row_edges))
    return photons, truth


def photon_time_stats(t, valid, truth_row, n_truth_rows: int, row_edges):
    """Per-row count, min, max, mean offset from the min and standard
    deviation of int32 times (reference: wfsim/core/rawdata.py:325-332);
    ``valid`` None counts every element.  Empty rows give (2^31-1,
    -(2^31-1)) as min and max, the identities wfsim_tpu uses.

    Each row's first and second moments are sums of that row's own
    min-centred integer times, so late rows lose no precision (wfsim_tpu
    took both from one float32 cumsum over all rows).  CPU tensors run
    :func:`photon_time_stats_ref` (float64 sums, exact below 2^53); CUDA
    tensors the row kernel of ``csrc/pmt_response.cu`` (int64 sums, exact
    while count x span^2 < 2^62, else a float64 second pass)."""
    if t.device.type == 'cpu':
        _check_edges(row_edges, t.shape[0])
        return photon_time_stats_ref(t, valid, truth_row, n_truth_rows,
                                     row_edges)
    if t.device.type != 'cuda':
        raise NotImplementedError(f'photon_time_stats on {t.device}')
    return _row_truth(None, None, t, valid, row_edges)
