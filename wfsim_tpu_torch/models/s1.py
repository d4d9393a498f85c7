"""S1 scintillation, ``simple`` model (counterpart of wfsim_tpu/models/s1.py
simulate_s1, s1.py:143-228; reference: wfsim/core/s1.py:60-238).

Detected photons per instruction are Binomial(amp, LCE/(1+p_dpe) * eff);
channels come from an inverse-CDF draw on the pattern map; times add an
exponential decay and a Gaussian spread, then the PMT response.  The photon
axis is allocated at its exact size once the yields are drawn.
"""
from __future__ import annotations

import torch

from ..ops.randsample import (categorical_from_cdf, binomial, uniform,
                              normal, exponential)
from ..ops.segment import segment_ids_from_counts, edges_from_counts
from .common import trunc_int
from .pmt import pmt_draws, pmt_response, photon_time_stats

__all__ = ['simulate_s1', 's1_n_photon_hits']


def s1_n_photon_hits(params, const, positions, amp, gen):
    """Detected photons: Binomial(amp, LCE/(1+p_dpe) * efficiency)
    (reference: s1.py:116-135)."""
    ly = params.s1_lce(positions)
    if ly.dim() > 1:
        ly = ly[..., 0]
    ly = ly / (1 + const.p_double_pe_emision) * const.s1_detection_efficiency
    return binomial(gen, amp, ly)


def row_edges_of(truth_row: torch.Tensor, inst_edges: torch.Tensor,
                 n_truth_rows: int):
    """Element boundaries of each truth row, from the per-instruction
    boundaries and the (ascending) truth row of each instruction."""
    first_inst = torch.searchsorted(
        truth_row.to(torch.int64),
        torch.arange(n_truth_rows + 1, device=truth_row.device))
    return inst_edges[first_inst]


def simulate_s1(params, const, inst, gen, *, n_truth_rows: int):
    """Simulate a batch of S1 instructions.

    :param inst: dict of (I,) tensors: time (int32, batch-relative ns), x, y,
        z (float32), amp (int32), recoil, truth_row (int64, ascending)
    :returns: (photons, truth, req_counts) — ``req_counts`` (I,) is each
        instruction's photon count; photons are grouped by instruction
    """
    if str(const.s1_model_type) != 'simple':
        raise NotImplementedError(
            f's1_model_type {const.s1_model_type!r}: the port has the '
            f'simple model only')
    dev = inst['x'].device
    positions = torch.stack([inst['x'], inst['y'], inst['z']], dim=1)
    n_hits = s1_n_photon_hits(params, const, positions, inst['amp'], gen)
    ph_inst = segment_ids_from_counts(n_hits)
    n = int(ph_inst.shape[0])

    # channels from the pattern map (reference: s1.py:137-159)
    pattern = params.s1_pattern(positions)
    if pattern.dim() == 1:
        pattern = pattern[:, None] * torch.ones((1, params.gains.shape[0]),
                                                device=dev)
    pattern = pattern * params.live_mask[None, :].to(pattern.dtype)
    cdf = torch.cumsum(pattern, dim=1)
    ch = categorical_from_cdf(cdf, ph_inst, uniform(gen, n, dev))
    ph_valid = ch >= 0

    # timings (reference: s1.py:191-194)
    t = inst['time'][ph_inst]
    t = t + trunc_int(exponential(gen, n, dev) * const.s1_decay_time)
    t = t + trunc_int(normal(gen, n, dev) * const.s1_decay_spread)

    inst_edges = edges_from_counts(n_hits)
    row_edges = row_edges_of(inst['truth_row'], inst_edges, n_truth_rows)
    truth_row = inst['truth_row'][ph_inst]
    photons, truth = pmt_response(params, const, t, ch, ph_valid, truth_row,
                                  pmt_draws(gen, n, dev),
                                  n_truth_rows=n_truth_rows,
                                  row_edges=row_edges)
    stats = photon_time_stats(photons['t'], photons['valid'], truth_row,
                              n_truth_rows, row_edges)
    truth.update({'photon_' + k: v for k, v in stats.items()})
    truth['n_electron'] = torch.zeros(n_truth_rows, dtype=torch.int32,
                                      device=dev)
    return photons, truth, n_hits
