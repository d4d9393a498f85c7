"""PMT response: transit-time spread, double-PE emission, SPE gain and the
truth counters (counterpart of wfsim_tpu/models/pmt.py; reference:
wfsim/core/pulse.py:39-144, 229-271).

The stage is a pure function of explicit draws (``pmt_draws``), so the
tests can hand both packages the same normals and uniforms.  CPU tensors
run the plain twins (``photon_pass_ref``, ``pulse_truth_ref``,
``photon_time_stats_ref``, ``pulse_truth_per_pmt_ref``); CUDA tensors
launch the entry points of ``csrc/pmt_response.cu``: the photon pass, one
block per truth row for the truth sums and the time statistics, and with
``per_pmt_truth`` one block per truth row for the per-PMT sums.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import Kernel, P, I, F, check_tensor, ptr, stream_of
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
                     [P, I, P, P, P, P, P, P, I, P, I, F, P, P, P, P, P, P,
                      P])
_per_pmt_kernel = Kernel('wfsim_pmt_row_truth_per_pmt',
                         [P, I, P, P, P, P, P, P, I, P, I, F, P, P, P])
#: the per-PMT kernel keeps 32 bytes a channel in a block's shared memory
MAX_PER_PMT_CHANNELS = 1536


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


def _row_truth(params, const, t, valid, row_edges, ph=None) -> dict:
    """The row kernel: time statistics of ``t`` (all valid where ``valid``
    is None) per row, and with the photons ``ph`` the truth sums too."""
    dev = t.device
    n = t.shape[0]
    R = row_edges.shape[0] - 1
    check_tensor('t', t, torch.int32, (n,), dev)
    check_tensor('row_edges', row_edges, torch.int64, (R + 1,), dev)
    if valid is not None:
        check_tensor('valid', valid, torch.bool, (n,), dev)
    if R and int(row_edges[-1]) > n:
        raise ValueError(f'row edges reach past the {n} elements')
    truth_args = (None, None, None, None, 0, None, 0, 0.0)
    if ph is not None:
        C = params.chan_pack.shape[0]
        dt = const.sample_duration
        check_tensor('ch', ph['ch'], torch.int32, (n,), dev)
        check_tensor('gain', ph['gain'], torch.float32, (n,), dev)
        check_tensor('is_dpe', ph['is_dpe'], torch.bool, (n,), dev)
        check_tensor('current_max', params.current_max, torch.float32,
                     (dt,), dev)
        truth_args = (ptr(ph['ch']), ptr(ph['gain']), ptr(ph['is_dpe']),
                      ptr(params.chan_pack), C, ptr(params.current_max), dt,
                      float(np.float32(const.current_2_adc)))
    sums = torch.zeros((len(TRUTH_SUMS), R), dtype=torch.float64, device=dev)
    out = dict(count=torch.empty(R, dtype=torch.int64, device=dev),
               t_min=torch.empty(R, dtype=torch.int32, device=dev),
               t_max=torch.empty(R, dtype=torch.int32, device=dev),
               t_mean_offset=torch.empty(R, dtype=torch.float64, device=dev),
               t_sigma=torch.empty(R, dtype=torch.float64, device=dev))
    if R:
        _row_kernel(ptr(row_edges), R, ptr(t),
                    None if valid is None else ptr(valid), *truth_args,
                    ptr(sums), ptr(out['count']), ptr(out['t_min']),
                    ptr(out['t_max']), ptr(out['t_mean_offset']),
                    ptr(out['t_sigma']), stream_of(dev))
    if ph is not None:
        out.update(zip(TRUTH_SUMS, sums))
    return out


def _row_truth_per_pmt(params, const, ph, row_edges) -> dict:
    """The per-PMT kernel: one block per truth row (see
    :func:`pulse_truth_per_pmt`)."""
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
    if R and int(row_edges[-1]) > n:
        raise ValueError(f'row edges reach past the {n} photons')
    counts = torch.empty((4, R, C), dtype=torch.int32, device=dev)
    areas = torch.empty((2, R, C), dtype=torch.float64, device=dev)
    if R:
        _per_pmt_kernel(ptr(row_edges), R, ptr(ph['t']), ptr(ph['valid']),
                        ptr(ph['ch']), ptr(ph['gain']), ptr(ph['is_dpe']),
                        ptr(params.chan_pack), C, ptr(params.current_max), dt,
                        float(np.float32(const.current_2_adc)), ptr(counts),
                        ptr(areas), stream_of(dev))
    return dict(zip(PER_PMT_SUMS, (*counts, *areas)))


def pulse_truth_per_pmt(params, const, ph, row_edges) -> dict:
    """Per-PMT truth of a photon batch from :func:`pmt_response`'s photon
    pass: the six sums of :data:`PER_PMT_SUMS`, each (R, C) with C =
    ``params.gains.shape[0]`` (counts int32, raw areas float64).  CPU
    tensors run :func:`pulse_truth_per_pmt_ref`; CUDA tensors the per-PMT
    kernel of ``csrc/pmt_response.cu``, whose float64 area atomics agree
    with the twin within rtol 1e-12."""
    dev = ph['t'].device
    if dev.type == 'cpu':
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
    min-centred integer times in float64, exact below 2^53, so late rows
    lose no precision (wfsim_tpu took both from one float32 cumsum over all
    rows).  CPU tensors run :func:`photon_time_stats_ref`; CUDA tensors the
    row kernel of ``csrc/pmt_response.cu``."""
    if t.device.type == 'cpu':
        return photon_time_stats_ref(t, valid, truth_row, n_truth_rows,
                                     row_edges)
    if t.device.type != 'cuda':
        raise NotImplementedError(f'photon_time_stats on {t.device}')
    return _row_truth(None, None, t, valid, row_edges)
