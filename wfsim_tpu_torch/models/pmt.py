"""PMT response: transit-time spread, double-PE emission, SPE gain and the
truth counters (counterpart of wfsim_tpu/models/pmt.py; reference:
wfsim/core/pulse.py:39-144, 229-271).

The stage is a pure function of explicit draws (``pmt_draws``), so the
tests can hand both packages the same normals and uniforms.
"""
from __future__ import annotations

import torch

from .common import trunc_int
from ..ops.randsample import uniform, normal
from ..ops.segment import sorted_segment_sum, segment_min_max, expand_rows

__all__ = ['pmt_draws', 'pmt_response', 'photon_time_stats']


def pmt_draws(gen, n: int, device) -> dict:
    """The per-photon draws of :func:`pmt_response`: a TTS normal, a DPE
    uniform and two SPE-gain uniforms."""
    return dict(tts=normal(gen, n, device), dpe=uniform(gen, n, device),
                u1=uniform(gen, n, device), u2=uniform(gen, n, device))


def pmt_response(params, const, t, ch, valid, truth_row, draws, *,
                 n_truth_rows: int, row_edges):
    """Apply the PMT response to a photon batch.

    :param t: (N,) int32 photon times (batch-relative ns)
    :param ch: (N,) int32 channels (-1 where no channel was drawn)
    :param valid: (N,) bool
    :param truth_row: (N,) int64 truth row per photon, ascending
    :param draws: dict from :func:`pmt_draws`
    :param row_edges: (n_truth_rows + 1,) photon boundaries of the rows
    :returns: (photons dict, truth dict)
    """
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
    photons = dict(t=t, ch=torch.where(valid, ch, -1), gain=gain,
                   is_dpe=is_dpe, valid=valid, truth_row=truth_row)
    truth = _pulse_truth(params, const, photons, n_truth_rows, row_edges)
    return photons, truth


def _pulse_truth(params, const, ph, n_truth_rows: int, row_edges):
    """Truth counters per row (reference: wfsim/core/pulse.py:229-271); the
    trigger test compares the photon's peak amplitude in ADC with the
    channel threshold.  Sums are float64 (exact for the counts)."""
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

    out = {}
    for name, x in (('n_photon', v1), ('n_pe', pe_w),
                    ('n_photon_trigger', trig), ('n_pe_trigger', pe_trig),
                    ('raw_area', gain_over_g), ('raw_area_trigger', area_trig)):
        out[name] = sorted_segment_sum(x, row_edges, valid=valid)
        out[name + '_bottom'] = sorted_segment_sum(x, row_edges, valid=bot)
    return out


def photon_time_stats(t, valid, truth_row, n_truth_rows: int, row_edges):
    """Per-row count, min, max, mean offset from the min and standard
    deviation of int32 times (reference: wfsim/core/rawdata.py:325-332).

    Each row's first and second moments are sums of that row's own
    min-centred integer times in float64, exact below 2^53, so late rows
    lose no precision (wfsim_tpu took both from one float32 cumsum over all
    rows).
    """
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
