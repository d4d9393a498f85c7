"""S2 electroluminescence (counterpart of wfsim_tpu/models/s2.py on the
main path: no field distortion, ``simple`` luminescence, AFT smearing and
transverse diffusion off, ``s2_time_spread`` timing; reference:
wfsim/core/s2.py).

Electrons per instruction survive extraction and the drift lifetime
(binomial), arrive with trapping and longitudinal diffusion, and each
makes Poisson(sc_gain) photons; photons get a channel from the pattern
map, a luminescence time, a gas-excimer delay and the S2 time spread.

:func:`simulate_s2` is :func:`s2_draws`, which makes the yields and every
per-electron and per-photon draw from the generator, followed by
:func:`s2_photon_pass`, a pure function of those draws.  On a CUDA device
the pass runs the hand-written kernels (electron and photon times,
luminescence tables, channel draw, PMT response); on the CPU their plain
twins.  Every reduction and division of the twins gives the same bits on
either device (float64 accumulations, divisions by float32 tensors), so a
kernel is held against its twin on the card and on the CPU alike.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import units
from .._build import Kernel, P, I, F, check_tensor, ptr, stream_of
from ..ops.randsample import (channel_draw, search_sorted_rows, binomial,
                              poisson, uniform, normal, exponential)
from ..ops.segment import segment_ids_from_counts, edges_from_counts
from .common import f32, singlet_triplet_delays, trunc_int
from .pmt import pmt_draws, pmt_response, photon_time_stats
from .s1 import masked_pattern, row_edges_of

__all__ = ['simulate_s2', 's2_draws', 's2_photon_pass', 's2_edges',
           'luminescence_simple', 'luminescence_tables',
           'luminescence_tables_ref', 's2_electron_times',
           's2_electron_times_ref', 's2_photon_times', 's2_photon_times_ref',
           'get_s2_drift_time_params']

#: quantile resolution of the per-instruction luminescence inverse CDFs
Q = 1024


def check_supported(const):
    for ok, what in (
            (const.field_distortion_model == 'none', 'field distortion'),
            (not const.enable_gas_gap_warping, 'gas-gap warping'),
            (not (const.en_drift_speed or const.en_diff_long
                  or const.en_survival_prob or const.en_diff_trans),
             'field-dependency maps'),
            (not const.se_gain_from_map and not const.ext_eff_from_map,
             'se-gain / extraction maps'),
            (const.diffusion_constant_transverse == 0,
             'transverse diffusion'),
            (const.s2_aft_sigma == 0, 'AFT smearing'),
            (const.s2_luminescence_model == 'simple', 'garfield luminescence'),
            ('optical_propagation' not in const.s2_time_model,
             'S2 optical propagation')):
        if not ok:
            raise NotImplementedError(f'the port has no {what} yet')
    if 's2_time_spread around zero' not in const.s2_time_model \
            and 'zero_delay' not in const.s2_time_model:
        raise KeyError(f'{const.s2_time_model} is not a valid s2_time_model')


def get_s2_drift_time_params(const, z_int):
    """Mean drift time and longitudinal-diffusion spread
    (reference: s2.py:157-179) at the configured drift velocity."""
    v = f32(const.drift_velocity_liquid, z_int)
    dlong = const.diffusion_constant_longitudinal
    drift_time_mean = torch.clamp_min(-z_int / v + const.drift_time_gate, 0.0)
    drift_time_spread = torch.sqrt(2 * dlong * drift_time_mean) / v
    return drift_time_mean, drift_time_spread


# ---------------------------------------------------------------------------
# luminescence tables (K6)


def _interp_rows(x_rows, y_rows, row_idx, q):
    """Per-sample linear interpolation y(q) on per-row monotone tables
    (the reference's per-instruction ``np.interp``, s2.py:338)."""
    R = x_rows.shape[-1]
    i1 = torch.clamp(search_sorted_rows(x_rows, row_idx, q, side='left'),
                     1, R - 1).to(torch.int64)
    i0 = i1 - 1
    row_idx = row_idx.to(torch.int64)
    x0, y0 = x_rows[row_idx, i0], y_rows[row_idx, i0]
    x1, y1 = x_rows[row_idx, i1], y_rows[row_idx, i1]
    w = torch.where(x1 > x0, (q - x0) / torch.clamp_min(x1 - x0, 1e-30), 0.0)
    w = torch.clamp(w, 0.0, 1.0)
    return y0 * (1 - w) + y1 * w


def _radius_grid(const, device):
    """The float32 radius grid ``r`` (np.arange, as jnp.arange makes it),
    ``rr = clamp(1/r, 1/rA, 1/rW)`` and the quantile grid ``qs``, built on
    the host so every device reads the same values."""
    rA = const.anode_field_domination_distance
    rW = const.anode_wire_radius
    r = torch.from_numpy(np.arange(const.gate_to_anode_distance, rW, -1e-4,
                                   dtype=np.float32))
    rr = torch.clamp(1 / r, 1 / rA, 1 / rW)
    qs = torch.linspace(0.0, 1.0, Q, dtype=torch.float32)
    return r.to(device), rr.to(device), qs.to(device)


def _anode_field(const, n_inst, device):
    """Per-instruction gas gap dG and anode field E0 (reference:
    s2.py:343-356), and the scalars of the integration."""
    number_density_gas = const.pressure / (units.boltzmannConstant
                                           * const.temperature)
    alpha = const.gas_drift_velocity_slope / number_density_gas
    rA = const.anode_field_domination_distance
    rW = const.anode_wire_radius
    dG = torch.full((n_inst,), const.elr_gas_gap_length, dtype=torch.float32,
                    device=device)
    dL = const.gate_to_anode_distance - dG
    VG = const.anode_voltage / (
        1 + dL / dG / f32(const.lxe_dielectric_constant, dG))
    E0 = VG / ((dG - rA) / f32(rA, dG) + np.log(rA / rW))
    return dG, E0, dict(alpha=alpha, field_unit=units.kV / units.cm,
                        dy_offset=0.8 * (const.pressure / units.bar))


def luminescence_tables_ref(const, n_inst: int, device):
    """Plain twin of :func:`luminescence_tables`."""
    dG, E0, s = _anode_field(const, n_inst, device)
    r, rr, qs = _radius_grid(const, device)
    mask = r[None, :] <= dG[:, None]
    dt = 1e-4 / (s['alpha'] * E0[:, None] * rr[None, :])
    dy = E0[:, None] * rr[None, :] / f32(s['field_unit'], E0) \
        - s['dy_offset']                          # arXiv:physics/0702142
    dt_m = torch.where(mask, dt, 0.0)
    dy_m = torch.where(mask, dy, 0.0)
    # float64 accumulations in sequence (torch's CPU cumsum), each value
    # rounded to float32 once; avgt's two sums are the last float64 values
    t64 = torch.cumsum(dt_m.to(torch.float64), dim=1)
    y64 = torch.cumsum(dy_m.to(torch.float64), dim=1)
    t_cum, y_cum = t64.to(torch.float32), y64.to(torch.float32)
    num = torch.cumsum((t_cum * dy_m).to(torch.float64), dim=1)[:, -1]
    avgt = (num / torch.clamp_min(y64[:, -1], 1e-30)).to(torch.float32)
    t_cum = t_cum - avgt[:, None]
    y_last = y_cum[:, -1]

    rq = torch.repeat_interleave(torch.arange(n_inst, device=device), Q)
    uq = (qs[None, :] * y_last[:, None]).reshape(-1)
    return _interp_rows(y_cum, t_cum, rq, uq).reshape(n_inst, Q)


_lumi_kernel = Kernel('wfsim_lumi_tables',
                      [P, P, I, P, I, P, P, I, F, F, F, P, P])


def luminescence_tables(const, n_inst: int, device):
    """(n_inst, Q) float32 inverse CDFs of the single-electron luminescence
    time (reference: s2.py:343-378): the electron drift through the anode
    field integrated on a fixed radius grid, centred on its light-weighted
    mean, resampled on a uniform quantile grid.

    On the CPU :func:`luminescence_tables_ref`; on a CUDA device the
    kernel ``csrc/luminescence.cu`` (one block per instruction)."""
    device = torch.device(device)
    if device.type == 'cpu':
        return luminescence_tables_ref(const, n_inst, device)
    if device.type != 'cuda':
        raise NotImplementedError(f'luminescence_tables on {device}')
    dG, E0, s = _anode_field(const, n_inst, device)
    r, rr, qs = _radius_grid(const, device)
    R = r.shape[0]
    if 2 * R * 4 > 200 * 1024:
        raise ValueError(f'a radius grid of {R} points does not fit the '
                         f'kernel\'s shared memory')
    inv = torch.empty((n_inst, Q), dtype=torch.float32, device=device)
    if n_inst:
        _lumi_kernel(ptr(r), ptr(rr), R, ptr(qs), Q, ptr(dG), ptr(E0), n_inst,
                     float(np.float32(s['alpha'])),
                     float(np.float32(s['field_unit'])),
                     float(np.float32(s['dy_offset'])), ptr(inv),
                     stream_of(device))
    return inv


def luminescence_simple(inv, ph_inst, u):
    """Luminescence time per photon from its instruction's inverse CDF
    ``inv`` (I, Q) and a uniform ``u``.  The lower table index is clamped
    to Q-2, so a ``u * (Q-1)`` that rounds up to Q-1 reads the last pair
    of its own row."""
    uq = u * (Q - 1)
    i0 = torch.clamp_max(torch.floor(uq).to(torch.int64), Q - 2)
    w = uq - i0.to(torch.float32)
    row = ph_inst.to(torch.int64)
    t_ph = inv[row, i0] * (1 - w) + inv[row, i0 + 1] * w
    return trunc_int(t_ph)


# ---------------------------------------------------------------------------
# draws


def s2_draws(params, const, inst, gen) -> dict:
    """The yields and per-electron and per-photon draws of an S2 batch, in
    the generator's order (reference: s2.py:211-315, 503-557):

    - ``n_electron`` (I,): Binomial(amp, extraction x lifetime survival);
    - per electron ``e_exp`` (trapping) and ``e_normal`` (diffusion);
    - ``n_ph_per_e`` (E,): Poisson(sc_gain), plus the truncated
      ``s2_gain_spread`` normal where it is on, clamped at 0 (the photon
      count sizes every photon draw after it, so it is part of the draw);
    - per photon ``u_ch`` (channel), ``u_lum`` (luminescence), ``u_st`` and
      ``exp_st`` (singlet/triplet), ``t_spread`` (the s2_time_spread
      normal, None under ``zero_delay``) and ``pmt`` (:func:`pmt_draws`).
    """
    dev = inst['x'].device
    z = inst['z']
    positions = torch.stack([inst['x'], inst['y']], dim=1)
    drift_time_mean, _ = get_s2_drift_time_params(const, z)
    cy = torch.full_like(z, const.electron_extraction_yield)
    cy = cy * torch.exp(-drift_time_mean
                        / f32(const.electron_lifetime_liquid, z))
    n_electron = binomial(gen, inst['amp'], cy)

    sc_gain = params.s2_correction(positions)
    if sc_gain.dim() > 1:
        sc_gain = sc_gain[..., 0]
    sc_gain = sc_gain * const.s2_secondary_sc_gain
    sc_gain = torch.nan_to_num(
        sc_gain / f32(1 + const.p_double_pe_emision, sc_gain), nan=0.0)

    n_e = int(n_electron.sum())
    e_exp = exponential(gen, n_e, dev)
    e_normal = normal(gen, n_e, dev)
    # the per-electron Poisson mean is the library sampler's input
    n_ph_per_e = poisson(gen, sc_gain[segment_ids_from_counts(n_electron)])
    if const.s2_gain_spread > 0:
        n_ph_per_e = n_ph_per_e + trunc_int(normal(gen, n_e, dev)
                                            * const.s2_gain_spread)
    n_ph_per_e = torch.clamp_min(n_ph_per_e, 0)

    n = int(n_ph_per_e.sum())
    d = dict(n_electron=n_electron, e_exp=e_exp, e_normal=e_normal,
             n_ph_per_e=n_ph_per_e, u_ch=uniform(gen, n, dev),
             u_lum=uniform(gen, n, dev), u_st=uniform(gen, n, dev),
             exp_st=exponential(gen, n, dev))
    d['t_spread'] = (normal(gen, n, dev)
                     if 's2_time_spread around zero' in const.s2_time_model
                     else None)
    d['pmt'] = pmt_draws(gen, n, dev)
    return d


# ---------------------------------------------------------------------------
# electron and photon times (K9)


def s2_electron_times_ref(time, e_edges, mean, spread, exp, nrm, truth_row,
                          *, trapping):
    """Plain twin of :func:`s2_electron_times`."""
    e_inst = segment_ids_from_counts(e_edges[1:] - e_edges[:-1])
    timing = exp * trapping
    timing = timing + (nrm * spread[e_inst] + mean[e_inst])
    return time[e_inst] + trunc_int(timing), e_inst, truth_row[e_inst]


_e_kernel = Kernel('wfsim_s2_electron_times',
                   [P, P, I, P, P, P, P, P, F, P, P, P, P])


def s2_electron_times(time, e_edges, mean, spread, exp, nrm, truth_row, *,
                      trapping):
    """Electron arrival times (reference: s2.py:258-315): ``time[i] +
    trunc(exp * trapping + (normal * spread[i] + mean[i]))`` for the
    electrons [e_edges[i], e_edges[i+1]) of instruction i.

    :returns: (e_t (E,) int32, e_inst (E,) int64, truth row (E,) int64)

    CPU tensors run :func:`s2_electron_times_ref`; CUDA tensors launch
    ``csrc/photon_times.cu``."""
    dev = time.device
    n_inst = time.shape[0]
    n = exp.shape[0]
    check_tensor('time', time, torch.int32, (n_inst,), dev)
    check_tensor('e_edges', e_edges, torch.int64, (n_inst + 1,), dev)
    for name, x in (('mean', mean), ('spread', spread)):
        check_tensor(name, x, torch.float32, (n_inst,), dev)
    for name, x in (('exp', exp), ('normal', nrm)):
        check_tensor(name, x, torch.float32, (n,), dev)
    check_tensor('truth_row', truth_row, torch.int64, (n_inst,), dev)
    if int(e_edges[-1]) != n:
        raise ValueError(f'{n} draws for {int(e_edges[-1])} electrons')
    if dev.type == 'cpu':
        return s2_electron_times_ref(time, e_edges, mean, spread, exp, nrm,
                                     truth_row, trapping=trapping)
    if dev.type != 'cuda':
        raise NotImplementedError(f's2_electron_times on {dev}')
    e_t = torch.empty(n, dtype=torch.int32, device=dev)
    e_inst = torch.empty(n, dtype=torch.int64, device=dev)
    e_row = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _e_kernel(ptr(time), ptr(e_edges), n_inst, ptr(mean), ptr(spread),
                  ptr(exp), ptr(nrm), ptr(truth_row),
                  float(np.float32(trapping)), ptr(e_t), ptr(e_inst),
                  ptr(e_row), stream_of(dev))
    return e_t, e_inst, e_row


def s2_photon_times_ref(inv, e_edges, e_ph_edges, e_t, truth_row, u_lum,
                        u_st, exp_st, t_spread, *, singlet_fraction,
                        t_singlet, t_triplet, time_spread):
    """Plain twin of :func:`s2_photon_times`."""
    e_inst = segment_ids_from_counts(e_edges[1:] - e_edges[:-1])
    ph_e = segment_ids_from_counts(e_ph_edges[1:] - e_ph_edges[:-1])
    ph_inst = e_inst[ph_e]
    t = luminescence_simple(inv, ph_inst, u_lum)
    t = t + singlet_triplet_delays(u_st, exp_st, singlet_fraction, t_singlet,
                                   t_triplet)
    if t_spread is not None:
        t = t + trunc_int(t_spread * time_spread)
    t = t + e_t[ph_e]
    return t, ph_inst, truth_row[ph_inst]


_ph_kernel = Kernel('wfsim_s2_photon_times',
                    [P, I, P, I, P, P, P, P, P, P, P, F, F, F, F, P, P, P,
                     P])


def s2_photon_times(inv, e_edges, e_ph_edges, e_t, truth_row, u_lum, u_st,
                    exp_st, t_spread, *, singlet_fraction, t_singlet,
                    t_triplet, time_spread):
    """S2 photon times (reference: s2.py:503-557): the luminescence lerp
    into the instruction's row of ``inv`` (:func:`luminescence_simple`),
    the gas singlet/triplet delay, ``trunc(t_spread * s2_time_spread)``
    (skipped where ``t_spread`` is None) and the electron's arrival time.
    Instruction i owns the electrons [e_edges[i], e_edges[i+1]); electron
    k the photons [e_ph_edges[k], e_ph_edges[k+1]).

    :returns: (t (N,) int32, ph_inst (N,) int64, truth row (N,) int64)

    CPU tensors run :func:`s2_photon_times_ref`; CUDA tensors launch
    ``csrc/photon_times.cu``."""
    dev = inv.device
    n_inst, q = inv.shape
    n_e = e_t.shape[0]
    n = u_lum.shape[0]
    check_tensor('inv', inv, torch.float32, (n_inst, q), dev)
    check_tensor('e_edges', e_edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('e_ph_edges', e_ph_edges, torch.int64, (n_e + 1,), dev)
    check_tensor('e_t', e_t, torch.int32, (n_e,), dev)
    check_tensor('truth_row', truth_row, torch.int64, (n_inst,), dev)
    for name, x in (('u_lum', u_lum), ('u_st', u_st), ('exp_st', exp_st),
                    *((('t_spread', t_spread),) if t_spread is not None
                      else ())):
        check_tensor(name, x, torch.float32, (n,), dev)
    if int(e_edges[-1]) != n_e or int(e_ph_edges[-1]) != n:
        raise ValueError('edges do not match the electron and photon draws')
    kw = dict(singlet_fraction=singlet_fraction, t_singlet=t_singlet,
              t_triplet=t_triplet, time_spread=time_spread)
    if dev.type == 'cpu':
        return s2_photon_times_ref(inv, e_edges, e_ph_edges, e_t, truth_row,
                                   u_lum, u_st, exp_st, t_spread, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f's2_photon_times on {dev}')
    if q < 2:
        raise ValueError('the inverse CDFs need >= 2 quantiles')
    t = torch.empty(n, dtype=torch.int32, device=dev)
    ph_inst = torch.empty(n, dtype=torch.int64, device=dev)
    ph_row = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _ph_kernel(ptr(inv), q, ptr(e_edges), n_inst, ptr(e_ph_edges),
                   ptr(e_t), ptr(truth_row), ptr(u_lum), ptr(u_st),
                   ptr(exp_st), None if t_spread is None else ptr(t_spread),
                   *(float(np.float32(v)) for v in (
                       singlet_fraction, t_singlet, t_triplet, time_spread)),
                   ptr(t), ptr(ph_inst), ptr(ph_row), stream_of(dev))
    return t, ph_inst, ph_row


# ---------------------------------------------------------------------------
# the pass


def s2_edges(draws):
    """(e_edges (I+1,), e_ph_edges (E+1,), ph_edges (I+1,)) int64: the
    electrons of each instruction, the photons of each electron and the
    photons of each instruction."""
    e_edges = edges_from_counts(draws['n_electron'])
    e_ph_edges = edges_from_counts(draws['n_ph_per_e'])
    return e_edges, e_ph_edges, e_ph_edges[e_edges]


def s2_photon_pass(params, const, inst, draws, *, n_truth_rows: int):
    """The S2 photons and truth of a batch given its draws
    (:func:`s2_draws`); a pure function of its arguments (inst as in
    ``s1_photon_pass``).

    :returns: (photons, truth, req_counts) — photons grouped by instruction
    """
    check_supported(const)
    dev = inst['x'].device
    n_inst = inst['x'].shape[0]
    positions = torch.stack([inst['x'], inst['y']], dim=1)
    e_edges, e_ph_edges, ph_edges = s2_edges(draws)
    mean, spread = get_s2_drift_time_params(const, inst['z'])
    e_t, _e_inst, e_row = s2_electron_times(
        inst['time'], e_edges, mean, spread, draws['e_exp'],
        draws['e_normal'], inst['truth_row'],
        trapping=const.electron_trapping_time)

    # channels from the pattern map (reference: s2.py:615-682 without AFT
    # smearing)
    ch = channel_draw(masked_pattern(params, params.s2_pattern, positions),
                      ph_edges, draws['u_ch'])
    # photon timing (reference: s2.py:503-557)
    t, _ph_inst, truth_row = s2_photon_times(
        luminescence_tables(const, n_inst, dev), e_edges, e_ph_edges, e_t,
        inst['truth_row'], draws['u_lum'], draws['u_st'], draws['exp_st'],
        draws['t_spread'], singlet_fraction=const.singlet_fraction_gas,
        t_singlet=const.singlet_lifetime_gas,
        t_triplet=const.triplet_lifetime_gas,
        time_spread=const.s2_time_spread)

    row_edges = row_edges_of(inst['truth_row'], ph_edges, n_truth_rows)
    photons, truth = pmt_response(params, const, t, ch, ch >= 0, truth_row,
                                  draws['pmt'], n_truth_rows=n_truth_rows,
                                  row_edges=row_edges)
    e_stats = photon_time_stats(
        e_t, None, e_row, n_truth_rows,
        row_edges_of(inst['truth_row'], e_edges, n_truth_rows))
    truth.update({'electron_' + k: v for k, v in e_stats.items()})
    n_el = torch.zeros(n_truth_rows, dtype=torch.int64, device=dev)
    n_el.index_add_(0, inst['truth_row'], draws['n_electron'].to(torch.int64))
    truth['n_electron'] = n_el
    return photons, truth, ph_edges[1:] - ph_edges[:-1]


def simulate_s2(params, const, inst, gen, *, n_truth_rows: int):
    """Simulate a batch of S2 instructions: :func:`s2_draws`, then
    :func:`s2_photon_pass` (inst and returns as there)."""
    check_supported(const)
    return s2_photon_pass(params, const, inst,
                          s2_draws(params, const, inst, gen),
                          n_truth_rows=n_truth_rows)
