"""S2 electroluminescence (counterpart of wfsim_tpu/models/s2.py on the
main path: no field distortion, ``simple`` luminescence, AFT smearing and
transverse diffusion off, ``s2_time_spread`` timing; reference:
wfsim/core/s2.py).

Electrons per instruction survive extraction and the drift lifetime
(binomial), arrive with trapping and longitudinal diffusion, and each
makes Poisson(sc_gain) photons; photons get a channel from the pattern
map, a luminescence time, a gas-excimer delay and the S2 time spread.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import units
from ..ops.randsample import (categorical_from_cdf, search_sorted_rows,
                              binomial, poisson, uniform, normal,
                              exponential)
from ..ops.segment import (segment_ids_from_counts, edges_from_counts,
                           expand_rows)
from .common import singlet_triplet_delays, trunc_int
from .pmt import pmt_draws, pmt_response, photon_time_stats
from .s1 import row_edges_of

__all__ = ['simulate_s2', 'luminescence_simple', 'luminescence_tables',
           's2_photon_channels', 'get_s2_drift_time_params']

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


def get_s2_drift_time_params(const, z_int):
    """Mean drift time and longitudinal-diffusion spread
    (reference: s2.py:157-179) at the configured drift velocity."""
    v = const.drift_velocity_liquid
    dlong = const.diffusion_constant_longitudinal
    drift_time_mean = torch.clamp_min(-z_int / v + const.drift_time_gate, 0.0)
    drift_time_spread = torch.sqrt(2 * dlong * drift_time_mean) / v
    return drift_time_mean, drift_time_spread


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


def luminescence_tables(const, n_inst: int, device):
    """(n_inst, Q) inverse CDFs of the single-electron luminescence time
    (reference: s2.py:343-378): the electron drift through the anode field
    integrated on a fixed radius grid, centred on its light-weighted mean,
    resampled on a uniform quantile grid."""
    number_density_gas = const.pressure / (units.boltzmannConstant
                                           * const.temperature)
    alpha = const.gas_drift_velocity_slope / number_density_gas
    uE = units.kV / units.cm
    pressure = const.pressure / units.bar
    rA = const.anode_field_domination_distance
    rW = const.anode_wire_radius

    dG = torch.full((n_inst,), const.elr_gas_gap_length, dtype=torch.float32,
                    device=device)
    dL = const.gate_to_anode_distance - dG
    VG = const.anode_voltage / (1 + dL / dG / const.lxe_dielectric_constant)
    E0 = VG / ((dG - rA) / rA + np.log(rA / rW))

    # the float32 grid np.arange makes, as jnp.arange does
    r = torch.from_numpy(np.arange(const.gate_to_anode_distance, rW, -1e-4,
                                   dtype=np.float32)).to(device)
    rr = torch.clamp(1 / r, 1 / rA, 1 / rW)
    mask = r[None, :] <= dG[:, None]
    dt = 1e-4 / (alpha * E0[:, None] * rr[None, :])
    dy = E0[:, None] * rr[None, :] / uE - 0.8 * pressure   # arXiv:physics/0702142
    dt_m = torch.where(mask, dt, 0.0)
    dy_m = torch.where(mask, dy, 0.0)
    t_cum = torch.cumsum(dt_m, dim=1)
    y_cum = torch.cumsum(dy_m, dim=1)
    avgt = torch.sum(t_cum * dy_m, dim=1) / torch.clamp_min(
        torch.sum(dy_m, dim=1), 1e-30)
    t_cum = t_cum - avgt[:, None]
    y_last = y_cum[:, -1]

    qs = torch.linspace(0.0, 1.0, Q, dtype=torch.float32, device=device)
    rq = torch.repeat_interleave(torch.arange(n_inst, device=device), Q)
    uq = (qs[None, :] * y_last[:, None]).reshape(-1)
    return _interp_rows(y_cum, t_cum, rq, uq).reshape(n_inst, Q)


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


def s2_photon_channels(params, xy_obs, ph_inst, u):
    """Channel per photon from the S2 pattern map (reference:
    s2.py:615-682 without AFT smearing)."""
    pattern = params.s2_pattern(xy_obs)
    if pattern.dim() == 1:
        pattern = pattern[:, None] * torch.ones(
            (1, params.gains.shape[0]), device=xy_obs.device)
    pattern = pattern * params.live_mask[None, :].to(pattern.dtype)
    cdf = torch.cumsum(pattern, dim=1)
    return categorical_from_cdf(cdf, ph_inst, u)


def _s2_electron_stage(params, const, inst, gen):
    """Yields, electron arrivals and photons per electron
    (reference: s2.py:211-315)."""
    dev = inst['x'].device
    x, y, z = inst['x'], inst['y'], inst['z']
    positions = torch.stack([x, y], dim=1)
    drift_time_mean, drift_time_spread = get_s2_drift_time_params(const, z)
    cy = torch.full_like(z, const.electron_extraction_yield)
    cy = cy * torch.exp(-drift_time_mean / const.electron_lifetime_liquid)
    n_electron = binomial(gen, inst['amp'], cy)

    sc_gain = params.s2_correction(positions)
    if sc_gain.dim() > 1:
        sc_gain = sc_gain[..., 0]
    sc_gain = sc_gain * const.s2_secondary_sc_gain
    sc_gain = torch.nan_to_num(sc_gain / (1 + const.p_double_pe_emision),
                               nan=0.0)

    e_inst = segment_ids_from_counts(n_electron)
    n_e = int(e_inst.shape[0])
    timing = exponential(gen, n_e, dev) * const.electron_trapping_time
    timing = timing + (normal(gen, n_e, dev) * drift_time_spread[e_inst]
                       + drift_time_mean[e_inst])
    e_t = inst['time'][e_inst] + trunc_int(timing)

    n_ph_per_e = poisson(gen, sc_gain[e_inst])
    if const.s2_gain_spread > 0:
        n_ph_per_e = n_ph_per_e + trunc_int(normal(gen, n_e, dev)
                                            * const.s2_gain_spread)
    n_ph_per_e = torch.clamp_min(n_ph_per_e, 0)
    return dict(positions=positions, n_electron=n_electron, e_inst=e_inst,
                e_t=e_t, n_ph_per_e=n_ph_per_e)


def simulate_s2(params, const, inst, gen, *, n_truth_rows: int):
    """Simulate a batch of S2 instructions (inst as in simulate_s1).

    :returns: (photons, truth, req_counts) — photons grouped by instruction
    """
    check_supported(const)
    dev = inst['x'].device
    st = _s2_electron_stage(params, const, inst, gen)
    positions, n_electron = st['positions'], st['n_electron']
    e_inst, e_t, n_ph_per_e = st['e_inst'], st['e_t'], st['n_ph_per_e']

    ph_e = segment_ids_from_counts(n_ph_per_e)
    n = int(ph_e.shape[0])
    ph_inst = e_inst[ph_e]

    ch = s2_photon_channels(params, positions, ph_inst, uniform(gen, n, dev))
    ph_valid = ch >= 0

    # photon timing (reference: s2.py:503-557)
    inv = luminescence_tables(const, positions.shape[0], dev)
    t = luminescence_simple(inv, ph_inst, uniform(gen, n, dev))
    t = t + singlet_triplet_delays(gen, n, const.singlet_fraction_gas,
                                   const.singlet_lifetime_gas,
                                   const.triplet_lifetime_gas, dev)
    if 's2_time_spread around zero' in const.s2_time_model:
        t = t + trunc_int(normal(gen, n, dev) * const.s2_time_spread)
    elif 'zero_delay' not in const.s2_time_model:
        raise KeyError(f'{const.s2_time_model} is not a valid s2_time_model')
    t = t + e_t[ph_e]

    n_inst = inst['x'].shape[0]
    req_counts = torch.zeros(n_inst, dtype=torch.int64, device=dev)
    req_counts.index_add_(0, e_inst, n_ph_per_e.to(torch.int64))
    inst_ph_edges = edges_from_counts(req_counts)
    row_edges = row_edges_of(inst['truth_row'], inst_ph_edges, n_truth_rows)
    truth_row = inst['truth_row'][ph_inst]
    photons, truth = pmt_response(params, const, t, ch, ph_valid, truth_row,
                                  pmt_draws(gen, n, dev),
                                  n_truth_rows=n_truth_rows,
                                  row_edges=row_edges)
    stats = photon_time_stats(photons['t'], photons['valid'], truth_row,
                              n_truth_rows, row_edges)
    truth.update({'photon_' + k: v for k, v in stats.items()})

    e_row_edges = row_edges_of(inst['truth_row'],
                               edges_from_counts(n_electron), n_truth_rows)
    e_stats = photon_time_stats(e_t, torch.ones_like(e_t, dtype=torch.bool),
                                inst['truth_row'][e_inst], n_truth_rows,
                                e_row_edges)
    truth.update({'electron_' + k: v for k, v in e_stats.items()})
    n_el = torch.zeros(n_truth_rows, dtype=torch.int64, device=dev)
    n_el.index_add_(0, inst['truth_row'], n_electron.to(torch.int64))
    truth['n_electron'] = n_el
    return photons, truth, req_counts
