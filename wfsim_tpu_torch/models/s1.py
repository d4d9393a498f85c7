"""S1 scintillation, ``simple`` model (counterpart of wfsim_tpu/models/s1.py
simulate_s1, s1.py:143-228; reference: wfsim/core/s1.py:60-238).

Detected photons per instruction are Binomial(amp, LCE/(1+p_dpe) * eff);
channels come from an inverse-CDF draw on the pattern map; times add an
exponential decay and a Gaussian spread, then the PMT response.  The photon
axis is allocated at its exact size once the yields are drawn.

:func:`simulate_s1` is :func:`s1_draws`, which makes the yields and every
per-photon draw from the generator, followed by :func:`s1_photon_pass`, a
pure function of those draws.  On a CUDA device the pass runs the
hand-written kernels (photon times, channel draw, PMT response); on the
CPU their plain twins.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import Kernel, P, I, F, check_tensor, ptr, stream_of
from ..ops.randsample import (channel_draw, binomial, uniform, normal,
                              exponential)
from ..ops.segment import segment_ids_from_counts, edges_from_counts
from .common import f32, trunc_int
from .pmt import pmt_draws, pmt_response

__all__ = ['simulate_s1', 's1_draws', 's1_photon_pass', 's1_n_photon_hits',
           's1_photon_times', 's1_photon_times_ref', 'masked_pattern']


def s1_n_photon_hits(params, const, positions, amp, gen):
    """Detected photons: Binomial(amp, LCE/(1+p_dpe) * efficiency)
    (reference: s1.py:116-135)."""
    ly = params.s1_lce(positions)
    if ly.dim() > 1:
        ly = ly[..., 0]
    ly = ly / f32(1 + const.p_double_pe_emision, ly) \
        * const.s1_detection_efficiency
    return binomial(gen, amp, ly)


def row_edges_of(truth_row: torch.Tensor, inst_edges: torch.Tensor,
                 n_truth_rows: int):
    """Element boundaries of each truth row, from the per-instruction
    boundaries and the (ascending) truth row of each instruction."""
    first_inst = torch.searchsorted(
        truth_row.to(torch.int64),
        torch.arange(n_truth_rows + 1, device=truth_row.device))
    return inst_edges[first_inst]


def masked_pattern(params, pattern_map, positions):
    """(I, C) float32 pattern of each instruction times the live mask."""
    pattern = pattern_map(positions)
    if pattern.dim() == 1:
        pattern = pattern[:, None] * torch.ones(
            (1, params.gains.shape[0]), device=positions.device)
    return pattern * params.live_mask[None, :].to(pattern.dtype)


def _positions(inst):
    return torch.stack([inst['x'], inst['y'], inst['z']], dim=1)


def s1_draws(params, const, inst, gen) -> dict:
    """The yields and per-photon draws of an S1 batch, in the generator's
    order: the binomial photon counts ``n_hits``, then per photon the
    channel uniform ``u_ch``, the decay exponential ``exp``, the spread
    normal ``normal`` and the PMT draws ``pmt`` (:func:`pmt_draws`)."""
    dev = inst['x'].device
    n_hits = s1_n_photon_hits(params, const, _positions(inst), inst['amp'],
                              gen)
    n = int(n_hits.sum())
    return dict(n_hits=n_hits, u_ch=uniform(gen, n, dev),
                exp=exponential(gen, n, dev), normal=normal(gen, n, dev),
                pmt=pmt_draws(gen, n, dev))


def s1_photon_times_ref(time, edges, truth_row, exp, nrm, *, decay_time,
                        decay_spread):
    """Plain twin of :func:`s1_photon_times`."""
    ph_inst = segment_ids_from_counts(edges[1:] - edges[:-1])
    t = time[ph_inst]
    t = t + trunc_int(exp * decay_time)
    t = t + trunc_int(nrm * decay_spread)
    return t, ph_inst, truth_row[ph_inst]


_times_kernel = Kernel('wfsim_s1_photon_times',
                       [P, P, P, I, P, P, F, F, P, P, P, P])


def s1_photon_times(time, edges, truth_row, exp, nrm, *, decay_time,
                    decay_spread):
    """Photon times of the simple S1 model (reference: s1.py:191-194):
    ``time[i] + trunc(exp * decay_time) + trunc(normal * decay_spread)``
    for the photons [edges[i], edges[i+1]) of instruction i.

    :returns: (t (N,) int32, ph_inst (N,) int64, truth row (N,) int64)

    CPU tensors run :func:`s1_photon_times_ref`; CUDA tensors launch
    ``csrc/photon_times.cu``."""
    dev = time.device
    n_inst = time.shape[0]
    n = exp.shape[0]
    check_tensor('time', time, torch.int32, (n_inst,), dev)
    check_tensor('edges', edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('truth_row', truth_row, torch.int64, (n_inst,), dev)
    check_tensor('exp', exp, torch.float32, (n,), dev)
    check_tensor('normal', nrm, torch.float32, (n,), dev)
    if int(edges[-1]) != n:
        raise ValueError(f'{n} draws for {int(edges[-1])} photons')
    kw = dict(decay_time=decay_time, decay_spread=decay_spread)
    if dev.type == 'cpu':
        return s1_photon_times_ref(time, edges, truth_row, exp, nrm, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f's1_photon_times on {dev}')
    t = torch.empty(n, dtype=torch.int32, device=dev)
    ph_inst = torch.empty(n, dtype=torch.int64, device=dev)
    ph_row = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _times_kernel(ptr(time), ptr(edges), ptr(truth_row), n_inst,
                      ptr(exp), ptr(nrm), float(np.float32(decay_time)),
                      float(np.float32(decay_spread)), ptr(t), ptr(ph_inst),
                      ptr(ph_row), stream_of(dev))
    return t, ph_inst, ph_row


def s1_photon_pass(params, const, inst, draws, *, n_truth_rows: int):
    """The S1 photons and truth of a batch given its draws
    (:func:`s1_draws`); a pure function of its arguments.

    :param inst: dict of (I,) tensors: time (int32, batch-relative ns), x, y,
        z (float32), amp (int32), truth_row (int64, ascending)
    :returns: (photons, truth, req_counts) — ``req_counts`` (I,) is each
        instruction's photon count; photons are grouped by instruction
    """
    n_hits = draws['n_hits']
    inst_edges = edges_from_counts(n_hits)
    t, _ph_inst, truth_row = s1_photon_times(
        inst['time'], inst_edges, inst['truth_row'], draws['exp'],
        draws['normal'], decay_time=const.s1_decay_time,
        decay_spread=const.s1_decay_spread)
    # channels from the pattern map (reference: s1.py:137-159)
    ch = channel_draw(masked_pattern(params, params.s1_pattern,
                                     _positions(inst)),
                      inst_edges, draws['u_ch'])
    row_edges = row_edges_of(inst['truth_row'], inst_edges, n_truth_rows)
    photons, truth = pmt_response(params, const, t, ch, ch >= 0, truth_row,
                                  draws['pmt'], n_truth_rows=n_truth_rows,
                                  row_edges=row_edges)
    truth['n_electron'] = torch.zeros(n_truth_rows, dtype=torch.int32,
                                      device=t.device)
    return photons, truth, n_hits


def simulate_s1(params, const, inst, gen, *, n_truth_rows: int):
    """Simulate a batch of S1 instructions: :func:`s1_draws`, then
    :func:`s1_photon_pass` (inst and returns as there)."""
    if str(const.s1_model_type) != 'simple':
        raise NotImplementedError(
            f's1_model_type {const.s1_model_type!r}: the port has the '
            f'simple model only')
    return s1_photon_pass(params, const, inst,
                          s1_draws(params, const, inst, gen),
                          n_truth_rows=n_truth_rows)
