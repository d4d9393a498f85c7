"""S2 electroluminescence (counterpart of wfsim_tpu/models/s2.py: inverse
FDC and COMSOL field distortion, the field-dependency maps (drift speed,
longitudinal and transverse diffusion, survival), the se-gain and
extraction maps, ``simple`` (with gas-gap warping), ``garfield`` and
``garfield_gas_gap`` luminescence, transverse diffusion of the pattern,
AFT smearing, ``s2_time_spread`` and optical-propagation timing;
reference: wfsim/core/s2.py).

Electrons per instruction survive extraction, the drift lifetime and the
survival map (binomial), arrive with trapping and longitudinal diffusion,
and each makes Poisson(sc_gain) photons; photons get a channel from the
pattern map (averaged over the transversely diffused electron positions,
its area fraction top smeared), a luminescence time, a gas-excimer delay
and the S2 time spread or the optical propagation delay of their array.

:func:`simulate_s2` is :func:`s2_draws`, which makes the yields and every
per-electron, per-instruction and per-photon draw from the generator,
followed by :func:`s2_photon_pass`, a pure function of those draws.  On a
CUDA device the pass runs the hand-written kernels (electron and photon
times, luminescence tables, wire-table and gas-gap samplers, diffused
pattern, map lookups, channel draw, PMT response); on the CPU their plain
twins.  Every
reduction and division of the twins gives the same bits on either device
(float64 or fixed-point accumulations, divisions by float32 tensors, no
transcendental functions at instruction width), so a kernel is held
against its twin on the card and on the CPU alike.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import units
from .._build import (Kernel, P, I, F, check_tensor, ptr, scratch,
                      stream_of)
from ..ops.interp import grid_lookup_ref
from ..ops.randsample import (channel_draw, search_sorted_rows, binomial,
                              poisson, uniform, normal, exponential)
from ..ops.segment import segment_ids_from_counts, edges_from_counts
from .common import (f32, singlet_triplet_delays, skew_normal, sqrt_f32,
                     trunc_int, rz_lookup, check_edges, check_segments)
from .pmt import pmt_draws, pmt_response, photon_time_stats
from .s1 import live_pattern, row_edges_of

__all__ = ['simulate_s2', 's2_draws', 's2_photon_pass', 's2_edges',
           'luminescence_simple', 'luminescence_tables',
           'luminescence_tables_ref', 'lumi_sequential_rows',
           'lumi_sequential_rows_ref', 's2_electron_times',
           's2_electron_times_ref', 's2_photon_times', 's2_photon_times_ref',
           'get_s2_drift_time_params', 'get_avg_drift_velocity',
           'electron_yield_probability', 'get_s2_light_yield',
           'inverse_field_distortion_correction', 'field_distortion_comsol',
           's2_time_mode', 'optical_delays',
           's2_positions', 'gasgap_rows', 'lumi_gasgap_times',
           'lumi_gasgap_times_ref', 'diffusion_inputs', 'pattern_diffuse',
           'pattern_diffuse_ref', 'diffuse_chunks', 's2_pattern', 'aft_smear',
           'lumi_garfield_times', 'lumi_garfield_times_ref',
           'tilt_coefficients', 'LUMINESCENCE_MODELS']

#: the ``s2_luminescence_model`` values the port runs (all of wfsim_tpu's)
LUMINESCENCE_MODELS = ('simple', 'garfield', 'garfield_gas_gap')

#: quantile resolution of the per-instruction luminescence inverse CDFs
Q = 1024

#: the gas-gap sampler's per-instruction time sums are int64 in units of
#: 2^-32 ns, so they are exact and the same in any order on any device
FIXED_POINT_SCALE = 2.0 ** 32


#: the ``s2_time_model`` parts wfsim_tpu runs (s2.py:504-515)
S2_TIME_MODELS = ('optical_propagation', 'zero_delay',
                  's2_time_spread around zero')


def check_supported(const):
    """Raise KeyError on an S2 model string wfsim_tpu does not run."""
    if const.s2_luminescence_model not in LUMINESCENCE_MODELS:
        raise KeyError(f'{const.s2_luminescence_model} is not a valid '
                       f's2_luminescence_model')
    if not any(m in const.s2_time_model for m in S2_TIME_MODELS):
        raise KeyError(f'{const.s2_time_model} is not a valid s2_time_model')


def s2_time_mode(params, const) -> str:
    """The photon-time term of the S2 chain (wfsim_tpu s2.py:504-515):
    'optical' (an ``optical_propagation`` model with its spline loaded),
    else 'zero' (``zero_delay``), else 'spread' (``s2_time_spread around
    zero``); KeyError otherwise, as there."""
    model = const.s2_time_model
    if 'optical_propagation' in model and params.s2_prop_top is not None:
        return 'optical'
    if 'zero_delay' in model:
        return 'zero'
    if 's2_time_spread around zero' in model:
        return 'spread'
    raise KeyError(f'{model} is not a valid s2_time_model')


def diffusion_on(const) -> bool:
    """Transverse diffusion of the pattern: a constant diffusion
    coefficient (reference: s2.py:637-640), or the radial and azimuthal
    diffusion maps (``enable_field_dependencies['diffusion_transverse_map']``,
    wfsim_tpu s2.py:473-477)."""
    return const.diffusion_constant_transverse > 0 or const.en_diff_trans


# ---------------------------------------------------------------------------
# field distortion and positions


def inverse_field_distortion_correction(params, x, y, z):
    """6-iteration fixed-point inversion of the field-distortion correction
    (reference: s2.py:29-53; wfsim_tpu s2.py:37): ``(z_obs, xy_obs (I, 2))``."""
    positions = torch.stack([x, y, z], dim=1)
    dr_pre = torch.zeros_like(x)
    for i_iter in range(6):
        dr = params.fdc_3d(positions)
        if dr.dim() > 1:
            dr = dr[..., 0]
        if i_iter > 0:
            dr = 0.5 * dr + 0.5 * dr_pre
        dr_pre = dr
        r_obs = sqrt_f32(x * x + y * y) - dr
        x_obs = x * r_obs / (r_obs + dr)
        y_obs = y * r_obs / (r_obs + dr)
        z_obs = -sqrt_f32(z * z + dr * dr)
        positions = torch.stack([x_obs, y_obs, z_obs], dim=1)
    return z_obs, torch.stack([x_obs, y_obs], dim=1)


def unit_azimuth(x, y):
    """``(cos, sin)`` of the azimuth of (x, y) as x / r and y / r, (1, 0)
    at r = 0 as ``arctan2(0, 0) = 0`` gives: IEEE division and square root
    give the same bits on the CPU and the card, torch's transcendental
    functions do not (they differ from wfsim_tpu's in the last bit)."""
    r = sqrt_f32(x * x + y * y)
    inner = r > 0
    safe_r = torch.where(inner, r, 1.0)
    return (torch.where(inner, x / safe_r, 1.0),
            torch.where(inner, y / safe_r, 0.0))


def field_distortion_comsol(params, x, y, z):
    """COMSOL field distortion (reference: s2.py:55-71; wfsim_tpu
    s2.py:57): the observed radius from the (r, z) map, at the
    interaction's azimuth; ``(z, xy_obs (I, 2))``.  The azimuth enters as
    x / r and y / r (:func:`unit_azimuth`), not as cos and sin of
    ``arctan2(y, x)``, so r = 0 gives (r_obs, 0)."""
    r_obs = rz_lookup(params.fd_comsol, z, torch.stack([x, y], dim=1))
    cos_t, sin_t = unit_azimuth(x, y)
    return z, torch.stack([r_obs * cos_t, r_obs * sin_t], dim=1)


def s2_positions(params, const, inst):
    """(z, xy (I, 2)) where the electrons are observed: after the inverse
    field-distortion correction or the COMSOL distortion when it is on,
    else the interaction position (wfsim_tpu s2.py:397-404)."""
    fdm = const.field_distortion_model
    if fdm == 'inverse_fdc' and params.fdc_3d is not None:
        return inverse_field_distortion_correction(params, inst['x'],
                                                   inst['y'], inst['z'])
    if fdm == 'comsol' and params.fd_comsol is not None:
        return field_distortion_comsol(params, inst['x'], inst['y'],
                                       inst['z'])
    return inst['z'], torch.stack([inst['x'], inst['y']], dim=1)


def _first(m):
    """A map's first output: (n,) from (n, out_dim), or (n,) as it is."""
    return m[..., 0] if m.dim() > 1 else m


def get_avg_drift_velocity(params, const, z, xy):
    """Drift velocity at (z, xy) (reference: s2.py:138-155; wfsim_tpu
    s2.py:71): the drift-speed map's, in 1e-4 cm/ns, times the
    ``norm_drift_velocity`` scaling, where the map is on; else the
    configured one, a float32 constant."""
    if const.en_drift_speed and params.drift_speed_map is not None:
        v = rz_lookup(params.drift_speed_map, z, xy)
        return v * 1e-4 * const.drift_velocity_scaling
    return torch.full_like(z, const.drift_velocity_liquid)


def get_s2_drift_time_params(params, const, z_int, xy_int):
    """Mean drift time and longitudinal-diffusion spread at the
    interaction (reference: s2.py:157-179; wfsim_tpu s2.py:81), the
    diffusion coefficient from its map where that is on."""
    v = get_avg_drift_velocity(params, const, z_int, xy_int)
    if const.en_diff_long and params.diffusion_long_map is not None:
        dlong = rz_lookup(params.diffusion_long_map, z_int, xy_int)
    else:
        dlong = const.diffusion_constant_longitudinal
    drift_time_mean = torch.clamp_min(-z_int / v + const.drift_time_gate, 0.0)
    drift_time_spread = sqrt_f32(2 * dlong * drift_time_mean) / v
    return drift_time_mean, drift_time_spread


def get_s2_light_yield(params, const, positions):
    """Photons per extracted electron (reference: s2.py:181-209; wfsim_tpu
    s2.py:96): the se-gain map where ``se_gain_from_map`` is on, else the
    S2 correction map times ``s2_secondary_sc_gain``; over 1 + p_dpe, NaN
    as 0."""
    if const.se_gain_from_map and params.se_gain is not None:
        sc_gain = _first(params.se_gain(positions))
    else:
        sc_gain = (_first(params.s2_correction(positions))
                   * const.s2_secondary_sc_gain)
    return torch.nan_to_num(
        sc_gain / f32(1 + const.p_double_pe_emision, sc_gain), nan=0.0)


def electron_yield_probability(params, const, z_int, xy_int, positions):
    """An electron's probability to be extracted (reference:
    s2.py:211-256; wfsim_tpu s2.py:111): the extraction yield (with
    ``ext_eff_from_map``, g2 times the S2 correction over the se gain)
    times the lifetime survival over the mean drift time, times the
    survival map clipped to [0, 1] where that is on."""
    drift_time_mean, _ = get_s2_drift_time_params(params, const, z_int,
                                                  xy_int)
    if const.ext_eff_from_map:
        rel_s2_cor = _first(params.s2_correction(positions))
        if const.se_gain_from_map and params.se_gain is not None:
            se_gains = _first(params.se_gain(positions))
        else:
            se_gains = rel_s2_cor * const.s2_secondary_sc_gain
        cy = const.g2_mean * rel_s2_cor / torch.clamp_min(se_gains, 1e-30)
    else:
        cy = torch.full_like(z_int, const.electron_extraction_yield)
    cy = cy * torch.exp(-drift_time_mean
                        / f32(const.electron_lifetime_liquid, z_int))
    if const.en_survival_prob and params.survival_prob_map is not None:
        p_surv = rz_lookup(params.survival_prob_map, z_int, xy_int)
        cy = cy * torch.clamp(p_surv, 0.0, 1.0)
    return cy


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


def _gap_field(const, dG):
    """Anode field E0 of the float32 gas gaps ``dG`` (reference:
    s2.py:343-356; wfsim_tpu s2.py:183-191).  The divisors are float32
    tensors, as :func:`f32` makes them, filled on ``dG``'s device rather
    than copied there, so a call reads nothing back."""
    rA = const.anode_field_domination_distance
    rW = const.anode_wire_radius

    def div(value):
        return torch.full((), value, dtype=torch.float32, device=dG.device)
    dL = const.gate_to_anode_distance - dG
    VG = const.anode_voltage / (
        1 + dL / dG / div(const.lxe_dielectric_constant))
    return VG / ((dG - rA) / div(rA) + np.log(rA / rW))


def _lumi_scalars(const):
    """The scalars of the integration: the drift-velocity slope over the
    gas number density, the field unit and the light-yield offset."""
    number_density_gas = const.pressure / (units.boltzmannConstant
                                           * const.temperature)
    return dict(alpha=const.gas_drift_velocity_slope / number_density_gas,
                field_unit=units.kV / units.cm,
                dy_offset=0.8 * (const.pressure / units.bar))


def _anode_field(const, n_inst, device, dG=None):
    """Per-instruction gas gap ``dG`` (``elr_gas_gap_length`` unless a
    float32 (n_inst,) tensor is given) and anode field E0, and the scalars
    of the integration."""
    if dG is None:
        dG = torch.full((n_inst,), const.elr_gas_gap_length,
                        dtype=torch.float32, device=device)
    else:
        check_tensor('dG', dG, torch.float32, (n_inst,), torch.device(device))
    return dG, _gap_field(const, dG), _lumi_scalars(const)


def _lumi_terms(const, n_inst, device, dG):
    """The integration's float32 terms dt and dy, (n_inst, R), 0 outside
    each instruction's gas gap, and the quantile grid."""
    dG, E0, s = _anode_field(const, n_inst, device, dG)
    r, rr, qs = _radius_grid(const, device)
    mask = r[None, :] <= dG[:, None]
    dt = 1e-4 / (s['alpha'] * E0[:, None] * rr[None, :])
    dy = E0[:, None] * rr[None, :] / f32(s['field_unit'], E0) \
        - s['dy_offset']                          # arXiv:physics/0702142
    return torch.where(mask, dt, 0.0), torch.where(mask, dy, 0.0), qs


def luminescence_tables_ref(const, n_inst: int, device, dG=None):
    """Plain twin of :func:`luminescence_tables`."""
    dt_m, dy_m, qs = _lumi_terms(const, n_inst, device, dG)
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


def _exact_in_any_order(x):
    """Per row of float32 terms ``x``, whether every partial sum of the
    row, in any order, is exact in float64: every term is a multiple of
    2^e, e the exponent of the lowest set bit of the row's nonzero terms,
    so every partial sum is one below 2^(e+53) in magnitude.  Tested as
    the float64 sum of |x| < 2^(e+52), which holds exactly when the exact
    sum does (below 2^(e+53) that float64 sum is exact; from there on it
    cannot round below 2^(e+52)), in whatever order it is taken.  A row
    of zeros holds; a NaN or an infinity fails."""
    m, p = torch.frexp(x)
    sig = (m.to(torch.float64) * 2.0 ** 24).to(torch.int64).abs()
    low = torch.log2((sig & -sig).to(torch.float64)).to(torch.int64)
    e = torch.where(sig != 0, p.to(torch.int64) - 24 + low,
                    torch.iinfo(torch.int32).max).amin(dim=1)
    total = x.to(torch.float64).abs().sum(dim=1)
    # total < 2^(e+52) exactly: total = f * 2^q with f in [0.5, 1)
    q = torch.frexp(total)[1].to(torch.int64)
    return (total == 0) | (torch.isfinite(total) & (q <= e + 52))


def lumi_sequential_rows_ref(const, n_inst: int, device, dG=None):
    """(n_inst,) bool: the rows the kernel integrates on its sequential
    path, those whose t, y or light-weighted sum is not exact in float64
    in every order (:func:`_exact_in_any_order`; the light-weighted terms
    ``float32(t_cum * dy)`` from the sequential t_cum, which the kernel's
    scan gives wherever the t sum passes)."""
    dt_m, dy_m, _qs = _lumi_terms(const, n_inst, device, dG)
    t_cum = torch.cumsum(dt_m.to(torch.float64), dim=1).to(torch.float32)
    return ~(_exact_in_any_order(dt_m) & _exact_in_any_order(dy_m)
             & _exact_in_any_order(t_cum * dy_m))


_lumi_kernel = Kernel('wfsim_lumi_tables',
                      [P, P, I, P, I, P, P, I, F, F, F, F, F, P, P, P])


@functools.lru_cache(maxsize=8)
def _lumi_inputs(const, device):
    """The kernel's per-configuration inputs on ``device``: the radius and
    quantile grids, and the float32 scalars (the constant gas gap, its
    field E0 computed on the host as the twin computes it, alpha, the
    field unit, the light-yield offset).  Made once per configuration and
    device, so a call copies nothing to the card."""
    r, rr, qs = _radius_grid(const, device)
    dG, E0, s = _anode_field(const, 1, 'cpu')
    return r, rr, qs, tuple(float(np.float32(float(x))) for x in (
        dG[0], E0[0], s['alpha'], s['field_unit'], s['dy_offset']))


_SEQUENTIAL_ROWS: dict = {}


def lumi_sequential_rows(device):
    """The (1,) int32 count, on ``device``, of the rows the luminescence
    kernel has integrated on its sequential path (see
    ``csrc/luminescence.cu``) since the count was made or last zeroed.
    The kernel adds to it; no wrapper reads it back."""
    device = torch.device(device)
    if device not in _SEQUENTIAL_ROWS:
        _SEQUENTIAL_ROWS[device] = torch.zeros(1, dtype=torch.int32,
                                               device=device)
    return _SEQUENTIAL_ROWS[device]


def luminescence_tables(const, n_inst: int, device, dG=None):
    """(n_inst, Q) float32 inverse CDFs of the single-electron luminescence
    time (reference: s2.py:343-378): the electron drift through the anode
    field integrated on a fixed radius grid, centred on its light-weighted
    mean, resampled on a uniform quantile grid.  ``dG``, a float32
    (n_inst,) tensor on ``device``, gives each instruction its own gas gap
    (wfsim_tpu's gas-gap warping); by default every row has
    ``elr_gas_gap_length``.

    On the CPU :func:`luminescence_tables_ref`; on a CUDA device the
    kernel ``csrc/luminescence.cu`` (one block per instruction, one launch
    and no read-back a call)."""
    device = torch.device(device)
    if device.type == 'cpu':
        return luminescence_tables_ref(const, n_inst, device, dG)
    if device.type != 'cuda':
        raise NotImplementedError(f'luminescence_tables on {device}')
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    r, rr, qs, (dg0, e00, alpha, field_unit, dy_offset) = _lumi_inputs(
        const, device)
    E0 = None
    if dG is not None:
        dG, E0, _s = _anode_field(const, n_inst, device, dG)
    R = r.shape[0]
    if 2 * R * 4 > 200 * 1024:
        raise ValueError(f'a radius grid of {R} points does not fit the '
                         f'kernel\'s shared memory')
    inv = torch.empty((n_inst, Q), dtype=torch.float32, device=device)
    if n_inst:
        _lumi_kernel(ptr(r), ptr(rr), R, ptr(qs), Q,
                     None if dG is None else ptr(dG),
                     None if E0 is None else ptr(E0), n_inst, dg0, e00,
                     alpha, field_unit, dy_offset, ptr(inv),
                     ptr(lumi_sequential_rows(device)), stream_of(device))
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
# garfield gas-gap luminescence (K13a)


def gasgap_rows(params, xy):
    """Per instruction, the two gas-gap rows of the luminescence table and
    the fraction between them (wfsim_tpu s2.py:255-265): ``(lower (I,),
    upper (I,) int64, frac (I,) float32)``."""
    gg = params.garfield_gas_gap_map(xy)
    if gg.dim() > 1:
        gg = gg[..., 0]
    gaps = params.gg_gas_gap
    G = gaps.shape[0]
    ind = torch.clamp(torch.searchsorted(gaps, gg.contiguous(), right=True)
                      - 1, 0, G - 1)
    upper = torch.clamp(ind + 1, 0, G - 1)
    frac = (gg - gaps[ind]) / (gaps[1:2] - gaps[0:1])
    return ind, upper, frac


def lumi_gasgap_times_ref(inv_cdf, lower, upper, frac, ph_edges, u):
    """Plain twin of :func:`lumi_gasgap_times`."""
    ph = segment_ids_from_counts(ph_edges[1:] - ph_edges[:-1])
    M = inv_cdf.shape[1]
    s = u * (M - 2)
    i0 = torch.floor(s).to(torch.int64)
    i1 = torch.ceil(s).to(torch.int64)
    w = s - i0.to(torch.float32)
    lo, hi, f = lower[ph], upper[ph], frac[ph]

    def grab(i):
        a, b = inv_cdf[lo, i], inv_cdf[hi, i]
        return (b - a) * f + a
    t1 = grab(i0)
    t2 = grab(i1)
    T = (t2 - t1) * w + t1
    q = torch.round(T.to(torch.float64) * FIXED_POINT_SCALE).to(torch.int64)
    sums = torch.zeros(lower.shape[0], dtype=torch.int64, device=u.device)
    sums.index_add_(0, ph, q)
    cnt = torch.clamp_min(ph_edges[1:] - ph_edges[:-1], 1)
    mean = (sums.to(torch.float64) / FIXED_POINT_SCALE
            / cnt.to(torch.float64)).to(torch.float32)
    return trunc_int(T - mean[ph])


def check_fixed_point_range(inv_cdf, lower, upper, frac, ph_edges):
    """Raise ``OverflowError`` where an instruction's int64 fixed-point time
    sum (:data:`FIXED_POINT_SCALE`) could wrap: its photon count times the
    largest |T| it can sample must stay below 2^63 / 2^32 = 2^31 ns.  An
    instruction's times are lerps of its row pair at ``frac`` over the
    sampled columns 0..M-2, so their largest magnitude bounds |T|; the
    factor 1 + 2^-16 covers the float32 rounding of T and of this product,
    the + 1 ns the rounding of each term to 2^-32 ns.  Reads one number
    back from the card."""
    if lower.shape[0] == 0:
        return
    M = inv_cdf.shape[1]
    lo, hi = inv_cdf[lower, :M - 1], inv_cdf[upper, :M - 1]
    t_max = ((hi - lo) * frac[:, None] + lo).abs().amax(dim=1)
    worst = ((ph_edges[1:] - ph_edges[:-1]) * t_max).max().item()
    if fixed_point_fails(worst):
        raise OverflowError(
            f'an instruction\'s photons sum to ~{worst:.4g} ns, past the '
            f'int64 fixed-point range of its mean time ({2.0 ** 31:.4g} ns)')


def fixed_point_fails(worst: float) -> bool:
    """Whether photons whose |T| sum to at most ``worst`` ns could pass the
    int64 fixed-point range of :func:`check_fixed_point_range`."""
    return worst * (1 + 2.0 ** -16) + 1 >= 2.0 ** 31


_gasgap_kernel = Kernel('wfsim_lumi_gasgap_times',
                        [P, I, I, P, P, P, I, P, P, I, P, P, P])


def lumi_gasgap_times(inv_cdf, lower, upper, frac, ph_edges, u, *, t_max):
    """Luminescence times of the ``garfield_gas_gap`` model (wfsim_tpu
    s2.py:255 luminescence_garfield_gasgap; reference s2.py:411-483):
    photon j of instruction i interpolates the rows ``lower[i]`` and
    ``upper[i]`` of the gas-gap inverse CDFs at ``frac[i]`` and the
    quantile ``u[j] * (M-2)`` (the last, odd tail bin is not sampled), and
    the instruction's mean time is subtracted before the truncation.

    The mean is the photons' sum taken in int64 fixed point (2^-32 ns, each
    time rounded half to even), divided by the count in float64 and rounded
    to float32 once: exact, and the same in any order, so the kernel's
    parallel sum equals the twin's on either device.  wfsim_tpu sums in
    float32 (ROADMAP Queue 3 F12).  An instruction whose sum could pass
    int64 raises ``OverflowError`` (about 2^31 ns summed over its photons,
    e.g. 1.2e7 photons at the synthetic table's ~175 ns): where ``t_max``
    (a host float, the largest |T| any photon can take:
    ``SimParams.gg_t_max``, or :func:`~wfsim_tpu_torch.models.params.
    gasgap_time_max` of the table and the gas-gap values; ``math.inf``
    where none is known) times the photon total fits, nothing is checked;
    else :func:`check_fixed_point_range` decides, with one read-back.  The
    bound is never below that check's, so both raise on the same inputs.
    It counts the whole batch, not the
    largest instruction: at the synthetic table's bound (118.7 ns on the
    detector_physics map) a batch of more than ~1.8e7 photons reads back
    once a call.

    :param inv_cdf: (G, M) float32 per-gas-gap inverse CDFs
    :param lower, upper: (I,) int64 rows, ``frac`` (I,) float32
        (:func:`gasgap_rows`)
    :param ph_edges: (I+1,) int64: instruction i owns photons
        [ph_edges[i], ph_edges[i+1])
    :param u: (N,) float32 uniforms
    :returns: (N,) int32 times (ns)

    CPU tensors run :func:`lumi_gasgap_times_ref` and raise where the
    edges do not end at N; CUDA tensors launch ``csrc/table_samplers.cu``
    (a block an instruction of up to 8,192 photons; larger ones listed and
    cut into tiles of 4,096 photons, a sum pass and an apply pass), which
    reads nothing back and clamps the edges to the N photons (a photon
    past the last edge is not written)."""
    dev = inv_cdf.device
    n_inst = lower.shape[0]
    n = u.shape[0]
    check_tensor('inv_cdf', inv_cdf, torch.float32, inv_cdf.shape, dev)
    if inv_cdf.dim() != 2 or inv_cdf.shape[1] < 3:
        raise ValueError(f'inv_cdf of shape {tuple(inv_cdf.shape)}')
    check_tensor('lower', lower, torch.int64, (n_inst,), dev)
    check_tensor('upper', upper, torch.int64, (n_inst,), dev)
    check_tensor('frac', frac, torch.float32, (n_inst,), dev)
    check_tensor('ph_edges', ph_edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('u', u, torch.float32, (n,), dev)
    check_edges(ph_edges, n, 'uniforms')
    check_segments(n, n_inst, 'uniforms')
    if fixed_point_fails(n * float(t_max)):
        check_fixed_point_range(inv_cdf, lower, upper, frac, ph_edges)
    if dev.type == 'cpu':
        return lumi_gasgap_times_ref(inv_cdf, lower, upper, frac, ph_edges, u)
    if dev.type != 'cuda':
        raise NotImplementedError(f'lumi_gasgap_times on {dev}')
    if n >= 2 ** 31:
        raise ValueError(f'{n} photons: the kernel counts them as int')
    t = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        stream = stream_of(dev)
        # int64 sums, then uint32 tickets, the tiled instructions' list,
        # its count and the count of its reads
        acc = scratch(dev, stream, 2 * n_inst + 1)
        _gasgap_kernel(ptr(inv_cdf), *inv_cdf.shape, ptr(lower), ptr(upper),
                       ptr(frac), n_inst, ptr(ph_edges), ptr(u), n,
                       ptr(acc), ptr(t), stream)
    return t


# ---------------------------------------------------------------------------
# garfield wire-table luminescence (K13c)


def tilt_coefficients(tilt):
    """``(sin, cos)`` of the anode wires' angle as float32: the correctly
    rounded sin and cos of the float32 angle.  XLA's float32 sin and cos
    (wfsim_tpu s2.py:246) give the same bits at the default pi/4 and
    differ in the last bit for ~0.6 % of other angles."""
    a = float(np.float32(tilt))
    return float(np.float32(np.sin(a))), float(np.float32(np.cos(a)))


def lumi_garfield_times_ref(table, x_axis, xy, ph_edges, cols, u_wire=None,
                            *, avgt, tilt, pitch, confine):
    """Plain twin of :func:`lumi_garfield_times`."""
    if u_wire is not None:
        c = f32(confine, u_wire)
        d = torch.maximum(-c, u_wire * (c + c) + (-c))
    else:
        s, co = tilt_coefficients(tilt)
        rot_y = xy[:, 0] * f32(s, xy) + xy[:, 1] * f32(co, xy)
        p, half = f32(pitch, xy), f32(pitch / 2, xy)
        r = torch.fmod(rot_y + half, p)
        r = torch.where((r != 0) & ((r < 0) != (p < 0)), r + p, r)
        d = r - half
    rows = torch.argmin(torch.abs(d[:, None] - x_axis[None, :]), dim=1)
    ph = segment_ids_from_counts(ph_edges[1:] - ph_edges[:-1])
    return table[rows[ph], cols].to(torch.int32) - avgt


_garfield_kernel = Kernel('wfsim_lumi_garfield_times',
                          [P, I, I, P, P, P, I, P, P, I, F, F, F, F, F, I, P,
                           P])


def lumi_garfield_times(table, x_axis, xy, ph_edges, cols, u_wire=None, *,
                        avgt, tilt, pitch, confine):
    """Luminescence times of the ``garfield`` model (wfsim_tpu s2.py:234
    luminescence_garfield; reference s2.py:380-409).  Per instruction, the
    distance ``d`` of the electrons from the nearest anode wire: the
    position rotated by the wires' angle ``tilt``, its y modulo the wire
    pitch (``(y + pitch/2) mod pitch - pitch/2``, the remainder taking the
    pitch's sign), or, with ``confine`` > 0, ``-confine + u_wire * 2 *
    confine``; the table row whose distance ``x_axis`` is nearest ``d``
    (the lowest on a tie).  Photon j of instruction i reads that row at the
    column ``cols[j]``, truncated to int, minus ``avgt``.

    :param table: (R, M) float32 times; ``x_axis`` (R,) float32 distances
    :param xy: (I, 2) float32 observed positions
    :param ph_edges: (I+1,) int64: instruction i owns photons
        [ph_edges[i], ph_edges[i+1]), ending at the photon total N
    :param cols: (N,) int64 columns in [0, M)
    :param u_wire: (I,) float32 uniforms, given exactly when ``confine`` > 0
    :param avgt: the int mean of the table (``SimParams.garfield_avgt``)
    :returns: (N,) int32 times (ns)

    CPU tensors run :func:`lumi_garfield_times_ref` and raise where the
    edges do not end at N; CUDA tensors launch ``csrc/table_samplers.cu``
    (one launch, tiles of 4,096 photons a block), which clamps the edges to
    the photons (a photon past the last edge is not written) and reads
    nothing back."""
    dev = table.device
    n_inst = xy.shape[0]
    n = cols.shape[0]
    if table.dim() != 2:
        raise ValueError(f'table of shape {tuple(table.shape)}')
    R, M = table.shape
    check_tensor('table', table, torch.float32, (R, M), dev)
    check_tensor('x_axis', x_axis, torch.float32, (R,), dev)
    check_tensor('xy', xy, torch.float32, (n_inst, 2), dev)
    check_tensor('ph_edges', ph_edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('cols', cols, torch.int64, (n,), dev)
    if (u_wire is not None) != (confine > 0):
        raise ValueError('u_wire is given exactly when confine > 0')
    if u_wire is not None:
        check_tensor('u_wire', u_wire, torch.float32, (n_inst,), dev)
    check_edges(ph_edges, n, 'photons')
    check_segments(n, n_inst, 'photons')
    kw = dict(avgt=int(avgt), tilt=tilt, pitch=pitch, confine=confine)
    if dev.type == 'cpu':
        return lumi_garfield_times_ref(table, x_axis, xy, ph_edges, cols,
                                       u_wire, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f'lumi_garfield_times on {dev}')
    if n >= 2 ** 31:
        raise ValueError(f'{n} photons: the kernel indexes them as int')
    t = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        s, co = tilt_coefficients(tilt)
        _garfield_kernel(ptr(table), R, M, ptr(x_axis), ptr(xy),
                         None if u_wire is None else ptr(u_wire), n_inst,
                         ptr(ph_edges), ptr(cols), n, s, co,
                         *(float(np.float32(v)) for v in (
                             pitch, pitch / 2, confine)),
                         int(avgt), ptr(t), stream_of(dev))
    return t


# ---------------------------------------------------------------------------
# transverse diffusion of the pattern (K12b) and AFT smearing


def diffusion_inputs(params, const, z, xy):
    """Per instruction the radial and azimuthal spreads of the electrons
    after the drift, and the cosine and sine of the azimuth (wfsim_tpu
    s2.py:309-327): ``(std_r, std_a, cos, sin)`` float32.  The drift
    velocity and, where the transverse-diffusion maps are on, the radial
    and azimuthal diffusion coefficients (their maps' values times 1e-9)
    are taken at the observed (z, xy); else both coefficients are
    ``diffusion_constant_transverse``.  The azimuth enters as x / r and
    y / r (:func:`unit_azimuth`), not as cos(arctan2(y, x))."""
    v = get_avg_drift_velocity(params, const, z, xy)
    if const.en_diff_trans and params.diffusion_radial_map is not None:
        d_rad = rz_lookup(params.diffusion_radial_map, z, xy) * 1e-9
        d_azi = rz_lookup(params.diffusion_azimuthal_map, z, xy) * 1e-9
    else:
        d_rad = d_azi = torch.full_like(z, const.diffusion_constant_transverse)
    drift_time_mean = torch.clamp_min(-z / v, 0.0)
    std_r = sqrt_f32(2 * d_rad * drift_time_mean)
    std_a = std_r if d_azi is d_rad else sqrt_f32(2 * d_azi * drift_time_mean)
    return (std_r, std_a, *unit_azimuth(xy[:, 0], xy[:, 1]))


def pattern_diffuse_ref(pattern_map, x, y, std_r, std_a, cos_t, sin_t,
                        r2_max, e_edges, n_r, n_a, n_channels: int):
    """Plain twin of :func:`pattern_diffuse`: materialises the (E, C)
    per-electron patterns."""
    counts = e_edges[1:] - e_edges[:-1]
    e_inst = segment_ids_from_counts(counts)
    hr = n_r * std_r[e_inst]
    ha = n_a * std_a[e_inst]
    ct, st = cos_t[e_inst], sin_t[e_inst]
    dx = hr * ct - ha * st
    dy = hr * st + ha * ct
    xe = x[e_inst] + dx
    ye = y[e_inst] + dy
    inside = (xe * xe + ye * ye <= r2_max).to(torch.float64)
    pat = grid_lookup_ref(pattern_map.values, pattern_map.lows,
                          pattern_map.highs, torch.stack([xe, ye], dim=1))
    if pat.dim() == 1:
        pat = pat[:, None].expand(-1, n_channels)
    n_inst = x.shape[0]
    num = torch.zeros((n_inst, n_channels), dtype=torch.float64,
                      device=x.device)
    num.index_add_(0, e_inst, pat.to(torch.float64) * inside[:, None])
    den = torch.zeros(n_inst, dtype=torch.float64, device=x.device)
    den.index_add_(0, e_inst, inside)
    return (num / torch.clamp_min(den, 1.0)[:, None]).to(torch.float32)


_diffuse_kernel = Kernel('wfsim_pattern_diffuse',
                         [P, I, I, I, I, P, P, P, P, P, P, P, P, F, I, P, I,
                          P, P, I, I, P, P, P, P, P])
#: electrons a block of the diffused-pattern kernel sums in order; a longer
#: instruction is split across blocks (see pattern_diffuse)
DIFFUSE_CHUNK = 2048


def diffuse_chunks(n_electron):
    """0-d int64 tensor: the instructions' chunks of :data:`DIFFUSE_CHUNK`
    electrons past their first, from the (I,) electron counts (the blocks
    :func:`pattern_diffuse`'s kernel adds to its grid)."""
    return torch.div(torch.clamp_min(n_electron.to(torch.int64) - 1, 0),
                     DIFFUSE_CHUNK, rounding_mode='floor').sum()


def pattern_diffuse(pattern_map, x, y, std_r, std_a, cos_t, sin_t, r2_max,
                    e_edges, n_r, n_a, n_channels: int, n_split=None):
    """The S2 pattern of each instruction averaged over its transversely
    diffused electrons (wfsim_tpu/models/s2.py:300 s2_pattern_map_diffuse;
    reference s2.py:559-613).  Electron k of instruction i sits at
    ``(x[i], y[i]) + R(theta_i) (n_r[k] std_r[i], n_a[k] std_a[i])``;
    electrons outside the TPC radius (``r^2 > r2_max``) are left out; the
    pattern map is looked up at each electron and the inside electrons'
    patterns are averaged.

    The per-channel sums are float64; a float32 pattern value within a
    dynamic range of 2^k adds exactly while k + log2(electrons) <= 29, so
    the sum is then the same in any order (the twin's index_add_ on the
    card adds in another order than the kernel, and the kernel splits an
    instruction of more than :data:`DIFFUSE_CHUNK` electrons into chunks
    summed in order and then added in chunk order).  wfsim_tpu sums in
    float32 (ROADMAP Queue 3 F12).

    :param pattern_map: a 2-d :class:`~wfsim_tpu_torch.ops.interp.GridMap`
        with 1 or ``n_channels`` outputs
    :param x, y, std_r, std_a, cos_t, sin_t: (I,) float32
        (:func:`diffusion_inputs`)
    :param e_edges: (I+1,) int64 electron boundaries; ``n_r``, ``n_a`` (E,)
        float32 standard normals
    :param n_split: :func:`diffuse_chunks` of the electron counts, as an
        int (the S2 draws carry it as ``diff_split``); None takes the bound
        ``E // DIFFUSE_CHUNK``, whose scratch, zero fill and extra blocks
        the kernel then carries for chunks that may not exist
    :returns: (I, n_channels) float32

    CPU tensors run :func:`pattern_diffuse_ref` after checking that
    ``e_edges[-1]`` is the number of normals; CUDA tensors launch
    ``csrc/grid_lookup.cu`` (one block per instruction and per further
    chunk of a long one, a thread per two channels, each electron's
    geometry computed once; no (E, C) array is written) and read nothing
    back: the kernel reads no electron past the
    normals (the edges are clamped to them), and :func:`s2_draws` draws as
    many normals as the edges count."""
    vals = pattern_map.values
    dev = vals.device
    n_inst = x.shape[0]
    n_e = n_r.shape[0]
    if vals.dim() != 3 or vals.shape[-1] not in (1, n_channels):
        raise ValueError(f'pattern map of shape {tuple(vals.shape)}')
    check_tensor('values', vals, torch.float32, vals.shape, dev)
    for name, a in (('lows', pattern_map.lows), ('highs', pattern_map.highs)):
        check_tensor(name, a, torch.float32, (2,), dev)
    for name, a in (('x', x), ('y', y), ('std_r', std_r), ('std_a', std_a),
                    ('cos_t', cos_t), ('sin_t', sin_t)):
        check_tensor(name, a, torch.float32, (n_inst,), dev)
    check_tensor('e_edges', e_edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('n_r', n_r, torch.float32, (n_e,), dev)
    check_tensor('n_a', n_a, torch.float32, (n_e,), dev)
    args = (pattern_map, x, y, std_r, std_a, cos_t, sin_t, r2_max, e_edges,
            n_r, n_a, n_channels)
    if dev.type == 'cpu':
        if int(e_edges[-1]) != n_e:
            raise ValueError(f'{n_e} normals for {int(e_edges[-1])} '
                             f'electrons')
        if n_split is not None and n_split != int(
                diffuse_chunks(e_edges[1:] - e_edges[:-1])):
            raise ValueError(f'n_split {n_split} is not the chunk count')
        return pattern_diffuse_ref(*args)
    if dev.type != 'cuda':
        raise NotImplementedError(f'pattern_diffuse on {dev}')
    if n_e >= 2 ** 31 or vals.numel() >= 2 ** 31:
        raise ValueError(f'{n_e} electrons or a map of {vals.numel()} '
                         f'values: the kernel takes < 2^31')
    out = torch.empty((n_inst, n_channels), dtype=torch.float32, device=dev)
    if n_inst:
        # scratch of a split instruction's chunks: their float64 sums and
        # counts, and the chunks done an instruction
        n_extra = n_e // DIFFUSE_CHUNK if n_split is None else int(n_split)
        if not 0 <= n_extra <= n_e // DIFFUSE_CHUNK:
            raise ValueError(f'n_split {n_split} for {n_e} electrons')
        partial = part_count = done = None
        if n_extra:
            partial = torch.empty((n_inst + n_extra) * n_channels,
                                  dtype=torch.float64, device=dev)
            part_count = torch.empty(n_inst + n_extra, dtype=torch.int64,
                                     device=dev)
            done = torch.zeros(n_inst, dtype=torch.int32, device=dev)
        _diffuse_kernel(ptr(vals), vals.shape[0], vals.shape[1],
                        vals.shape[2], n_channels, ptr(pattern_map.lows),
                        ptr(pattern_map.highs), ptr(x), ptr(y), ptr(std_r),
                        ptr(std_a), ptr(cos_t), ptr(sin_t),
                        float(np.float32(r2_max)), n_inst, ptr(e_edges), n_e,
                        ptr(n_r), ptr(n_a), DIFFUSE_CHUNK, n_extra,
                        *(None if a is None else ptr(a)
                          for a in (partial, part_count, done)),
                        ptr(out), stream_of(dev))
    return out


def s2_pattern(params, const, z, xy, e_edges, draws):
    """(I, C) live-masked S2 pattern of each instruction: the pattern map
    at ``xy``, or averaged over the diffused electrons when transverse
    diffusion is on, then AFT-smeared when ``s2_aft_sigma`` is set
    (wfsim_tpu s2.py:355-374, 470-475)."""
    if diffusion_on(const):
        std_r, std_a, cos_t, sin_t = diffusion_inputs(params, const, z, xy)
        pattern = pattern_diffuse(
            params.s2_pattern, xy[:, 0].contiguous(), xy[:, 1].contiguous(),
            std_r, std_a, cos_t, sin_t, const.tpc_radius ** 2, e_edges,
            draws['diff_r'], draws['diff_a'], int(params.gains.shape[0]),
            draws.get('diff_split'))
    else:
        pattern = params.s2_pattern(xy)
    pattern = live_pattern(params, pattern)
    if const.s2_aft_sigma != 0:
        pattern = aft_smear(params, const, pattern, draws['aft_u0'],
                            draws['aft_v'])
    return pattern


def aft_smear(params, const, pattern, u0, v):
    """Skew-normal smearing of each instruction's area fraction top
    (wfsim_tpu s2.py:360-370; reference s2.py:650-672): the top and bottom
    channels are rescaled so the top fraction becomes ``aft * skewnorm``,
    clipped to [0, 1].  The two pattern sums are float64 rounded to float32
    once (exact, so the same on either device, for 494 positive float32
    values within a 2^20 dynamic range)."""
    top = params.top_mask[None, :].to(pattern.dtype)
    sum_all = pattern.to(torch.float64).sum(dim=1).to(torch.float32)
    sum_top = (pattern * top).to(torch.float64).sum(dim=1).to(torch.float32)
    cur_aft = sum_top / torch.clamp_min(sum_all, 1e-30)
    new_aft = cur_aft * skew_normal(u0, v, 1.0, const.s2_aft_sigma,
                                    const.s2_aft_skewness)
    new_aft = torch.clamp(new_aft, 0.0, 1.0)
    scale_top = new_aft / torch.clamp_min(cur_aft, 1e-30)
    scale_bot = (1 - new_aft) / torch.clamp_min(1 - cur_aft, 1e-30)
    return pattern * torch.where(top > 0, scale_top[:, None],
                                 scale_bot[:, None])


# ---------------------------------------------------------------------------
# draws


def s2_draws(params, const, inst, gen) -> dict:
    """The yields and per-electron, per-instruction and per-photon draws of
    an S2 batch, in the generator's order (reference: s2.py:211-315,
    503-557, 559-672):

    - ``n_electron`` (I,): Binomial(amp,
      :func:`electron_yield_probability`);
    - per electron ``e_exp`` (trapping) and ``e_normal`` (diffusion);
    - ``n_ph_per_e`` (E,): Poisson(sc_gain), plus the truncated
      ``s2_gain_spread`` normal where it is on, clamped at 0 (the photon
      count sizes every photon draw after it, so it is part of the draw);
    - with transverse diffusion, per electron the radial and azimuthal
      normals ``diff_r`` and ``diff_a``, and ``diff_split``, the
      :func:`diffuse_chunks` of ``n_electron`` as an int (read back with
      the electron total);
    - with AFT smearing, per instruction the skew-normal's two normals
      ``aft_u0`` and ``aft_v``;
    - per photon ``u_ch`` (channel), then the luminescence draws: ``u_lum``
      (a uniform per photon), or with ``garfield`` luminescence the
      instruction's wire uniform ``u_wire`` (only where
      ``s2_garfield_confine_position`` > 0) and the table column ``col``
      (int64 per photon); then per photon ``u_st`` and ``exp_st``
      (singlet/triplet), the time term's draw (:func:`s2_time_mode`: the
      s2_time_spread normal ``t_spread``, or the optical propagation
      uniform ``u_prop``; neither under ``zero_delay``) and ``pmt``
      (:func:`pmt_draws`).

    A switch that is off takes no draws (None).  The dict also carries the
    observed position ``z_obs``, ``xy_obs`` (:func:`s2_positions`): no draw,
    but the light yield needs it here and the pass reads it, so the
    field distortion runs once."""
    dev = inst['x'].device
    z = inst['z']
    z_obs, positions = s2_positions(params, const, inst)
    cy = electron_yield_probability(
        params, const, z, torch.stack([inst['x'], inst['y']], dim=1),
        positions)
    n_electron = binomial(gen, inst['amp'], cy)
    sc_gain = get_s2_light_yield(params, const, positions)

    if diffusion_on(const):
        n_e, n_split = torch.stack([n_electron.sum(),
                                    diffuse_chunks(n_electron)]).tolist()
    else:
        n_e, n_split = int(n_electron.sum()), None
    n_inst = int(z.shape[0])
    e_exp = exponential(gen, n_e, dev)
    e_normal = normal(gen, n_e, dev)
    # the per-electron Poisson mean is the library sampler's input
    n_ph_per_e = poisson(gen, sc_gain[segment_ids_from_counts(n_electron)])
    if const.s2_gain_spread > 0:
        n_ph_per_e = n_ph_per_e + trunc_int(normal(gen, n_e, dev)
                                            * const.s2_gain_spread)
    n_ph_per_e = torch.clamp_min(n_ph_per_e, 0)
    d = dict(z_obs=z_obs, xy_obs=positions, n_electron=n_electron,
             e_exp=e_exp, e_normal=e_normal, n_ph_per_e=n_ph_per_e,
             diff_r=None, diff_a=None, diff_split=n_split, aft_u0=None,
             aft_v=None)
    if diffusion_on(const):
        d['diff_r'] = normal(gen, n_e, dev)
        d['diff_a'] = normal(gen, n_e, dev)
    if const.s2_aft_sigma != 0:
        d['aft_u0'] = normal(gen, n_inst, dev)
        d['aft_v'] = normal(gen, n_inst, dev)

    n = int(n_ph_per_e.sum())
    d.update(u_ch=uniform(gen, n, dev), u_lum=None, u_wire=None, col=None)
    if const.s2_luminescence_model == 'garfield':
        if const.s2_garfield_confine_position > 0:
            d['u_wire'] = uniform(gen, n_inst, dev)
        d['col'] = torch.randint(int(params.garfield_t.shape[1]), (n,),
                                 generator=gen, device=dev)
    else:
        d['u_lum'] = uniform(gen, n, dev)
    d.update(u_st=uniform(gen, n, dev), exp_st=exponential(gen, n, dev))
    mode = s2_time_mode(params, const)
    d['t_spread'] = normal(gen, n, dev) if mode == 'spread' else None
    d['u_prop'] = uniform(gen, n, dev) if mode == 'optical' else None
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
    return time[e_inst] + trunc_int(timing), truth_row[e_inst]


_e_kernel = Kernel('wfsim_s2_electron_times',
                   [P, P, I, I, P, P, P, P, P, F, P, P, P])


def s2_electron_times(time, e_edges, mean, spread, exp, nrm, truth_row, *,
                      trapping):
    """Electron arrival times (reference: s2.py:258-315): ``time[i] +
    trunc(exp * trapping + (normal * spread[i] + mean[i]))`` for the
    electrons [e_edges[i], e_edges[i+1]) of instruction i.

    :returns: (e_t (E,) int32, truth row (E,) int64)

    CPU tensors run :func:`s2_electron_times_ref` and raise where the
    edges do not end at E; CUDA tensors launch ``csrc/photon_times.cu``
    (tiles of 1,024 electrons a block), which reads nothing back and
    clamps the edges to the E electrons (one past the last edge is not
    written)."""
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
    check_edges(e_edges, n, 'electron draws')
    check_segments(n, n_inst, 'electron draws')
    if dev.type == 'cpu':
        return s2_electron_times_ref(time, e_edges, mean, spread, exp, nrm,
                                     truth_row, trapping=trapping)
    if dev.type != 'cuda':
        raise NotImplementedError(f's2_electron_times on {dev}')
    if n >= 2 ** 31:
        raise ValueError(f'{n} electrons: the kernel counts them as int')
    e_t = torch.empty(n, dtype=torch.int32, device=dev)
    e_row = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        _e_kernel(ptr(time), ptr(e_edges), n_inst, n, ptr(mean),
                  ptr(spread), ptr(exp), ptr(nrm), ptr(truth_row),
                  float(np.float32(trapping)), ptr(e_t), ptr(e_row),
                  stream_of(dev))
    return e_t, e_row


def s2_photon_times_ref(inv, e_edges, e_ph_edges, e_t, truth_row, u_lum,
                        u_st, exp_st, t_spread, *, singlet_fraction,
                        t_singlet, t_triplet, time_spread, t_lum=None):
    """Plain twin of :func:`s2_photon_times`."""
    e_inst = segment_ids_from_counts(e_edges[1:] - e_edges[:-1])
    ph_e = segment_ids_from_counts(e_ph_edges[1:] - e_ph_edges[:-1])
    ph_inst = e_inst[ph_e]
    t = luminescence_simple(inv, ph_inst, u_lum) if t_lum is None else t_lum
    t = t + singlet_triplet_delays(u_st, exp_st, singlet_fraction, t_singlet,
                                   t_triplet)
    if t_spread is not None:
        t = t + trunc_int(t_spread * time_spread)
    t = t + e_t[ph_e]
    return t, truth_row[ph_inst]


_ph_kernel = Kernel('wfsim_s2_photon_times',
                    [P, I, P, I, P, I, I, P, P, P, P, P, P, P, F, F, F, F,
                     P, P, P])


def s2_photon_times(inv, e_edges, e_ph_edges, e_t, truth_row, u_lum, u_st,
                    exp_st, t_spread, *, singlet_fraction, t_singlet,
                    t_triplet, time_spread, t_lum=None):
    """S2 photon times (reference: s2.py:503-557): the luminescence time,
    the gas singlet/triplet delay, ``trunc(t_spread * s2_time_spread)``
    (skipped where ``t_spread`` is None) and the electron's arrival time.
    The luminescence time is the lerp into the instruction's row of the
    simple model's ``inv`` at ``u_lum`` (:func:`luminescence_simple`), or,
    where ``t_lum`` (N,) int32 is given, that (``inv`` and ``u_lum`` are
    then None; :func:`lumi_gasgap_times`).  Instruction i owns the
    electrons [e_edges[i], e_edges[i+1]); electron k the photons
    [e_ph_edges[k], e_ph_edges[k+1]).

    :returns: (t (N,) int32, truth row (N,) int64)

    CPU tensors run :func:`s2_photon_times_ref` and raise where the edges
    do not end at the electrons and photons; CUDA tensors launch
    ``csrc/photon_times.cu`` (tiles of 4,096 photons a block), which reads nothing back and clamps the edges to them (a
    photon past the last edges is not written)."""
    dev = e_t.device
    n_inst = truth_row.shape[0]
    n_e = e_t.shape[0]
    n = u_st.shape[0]
    if (t_lum is None) == (inv is None) or (inv is None) != (u_lum is None):
        raise ValueError('pass either inv and u_lum, or t_lum')
    q = 0
    if inv is not None:
        q = inv.shape[1]
        check_tensor('inv', inv, torch.float32, (n_inst, q), dev)
        check_tensor('u_lum', u_lum, torch.float32, (n,), dev)
    else:
        check_tensor('t_lum', t_lum, torch.int32, (n,), dev)
    check_tensor('e_edges', e_edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('e_ph_edges', e_ph_edges, torch.int64, (n_e + 1,), dev)
    check_tensor('e_t', e_t, torch.int32, (n_e,), dev)
    check_tensor('truth_row', truth_row, torch.int64, (n_inst,), dev)
    for name, x in (('u_st', u_st), ('exp_st', exp_st),
                    *((('t_spread', t_spread),) if t_spread is not None
                      else ())):
        check_tensor(name, x, torch.float32, (n,), dev)
    check_edges(e_edges, n_e, 'electrons')
    check_edges(e_ph_edges, n, 'photon draws')
    check_segments(n, n_e, 'photon draws')
    check_segments(n_e, n_inst, 'electrons')
    kw = dict(singlet_fraction=singlet_fraction, t_singlet=t_singlet,
              t_triplet=t_triplet, time_spread=time_spread, t_lum=t_lum)
    if dev.type == 'cpu':
        return s2_photon_times_ref(inv, e_edges, e_ph_edges, e_t, truth_row,
                                   u_lum, u_st, exp_st, t_spread, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f's2_photon_times on {dev}')
    if inv is not None and q < 2:
        raise ValueError('the inverse CDFs need >= 2 quantiles')
    if n >= 2 ** 31 or n_e >= 2 ** 31:
        raise ValueError(f'{n} photons of {n_e} electrons: the kernel '
                         f'counts them as int')
    t = torch.empty(n, dtype=torch.int32, device=dev)
    ph_row = torch.empty(n, dtype=torch.int64, device=dev)

    def opt(x):
        return None if x is None else ptr(x)
    if n:
        _ph_kernel(opt(inv), q, ptr(e_edges), n_inst, ptr(e_ph_edges), n_e,
                   n, ptr(e_t), ptr(truth_row), opt(u_lum),
                   opt(t_lum), ptr(u_st), ptr(exp_st), opt(t_spread),
                   *(float(np.float32(v)) for v in (
                       singlet_fraction, t_singlet, t_triplet, time_spread)),
                   ptr(t), ptr(ph_row), stream_of(dev))
    return t, ph_row


# ---------------------------------------------------------------------------
# the pass


def s2_edges(draws):
    """(e_edges (I+1,), e_ph_edges (E+1,), ph_edges (I+1,)) int64: the
    electrons of each instruction, the photons of each electron and the
    photons of each instruction."""
    e_edges = edges_from_counts(draws['n_electron'])
    e_ph_edges = edges_from_counts(draws['n_ph_per_e'])
    return e_edges, e_ph_edges, e_ph_edges[e_edges]


def mean_electron_position(xy, truth_row, n_truth_rows: int):
    """Per truth row, the mean observed (field-distorted) position of its
    instructions (wfsim_tpu s2.py:559-567): ``(x, y)`` float32, float64
    sums."""
    dev = xy.device
    cnt = torch.zeros(n_truth_rows, dtype=torch.float64, device=dev)
    cnt.index_add_(0, truth_row, torch.ones_like(xy[:, 0], dtype=torch.float64))
    out = []
    for k in (0, 1):
        s = torch.zeros(n_truth_rows, dtype=torch.float64, device=dev)
        s.index_add_(0, truth_row, xy[:, k].to(torch.float64))
        out.append((s / torch.clamp_min(cnt, 1.0)).to(torch.float32))
    return out


def optical_delays(params, const, ch, u):
    """The S2 photons' optical propagation delays (wfsim_tpu s2.py:504-509;
    reference s2.py:517-527): both splines at each photon's uniform ``u``,
    the top one for a top-array channel (``ch < n_top_pmts``, a photon
    without a channel included, as there), float32 (N,)."""
    pts = u[:, None]
    return torch.where(ch < const.n_top_pmts, _first(params.s2_prop_top(pts)),
                       _first(params.s2_prop_bottom(pts)))


def s2_photon_pass(params, const, inst, draws, *, n_truth_rows: int):
    """The S2 photons and truth of a batch given its draws
    (:func:`s2_draws`); a pure function of its arguments (inst as in
    ``s1_photon_pass``).

    :returns: (photons, truth, req_counts) — photons grouped by instruction
    """
    check_supported(const)
    dev = inst['x'].device
    n_inst = inst['x'].shape[0]
    z_obs, positions = draws['z_obs'], draws['xy_obs']
    e_edges, e_ph_edges, ph_edges = s2_edges(draws)
    mean, spread = get_s2_drift_time_params(
        params, const, inst['z'], torch.stack([inst['x'], inst['y']], dim=1))
    e_t, e_row = s2_electron_times(
        inst['time'], e_edges, mean, spread, draws['e_exp'],
        draws['e_normal'], inst['truth_row'],
        trapping=const.electron_trapping_time)

    # channels from the pattern (reference: s2.py:615-682)
    ch = channel_draw(s2_pattern(params, const, z_obs, positions, e_edges,
                                 draws), ph_edges, draws['u_ch'])
    # photon timing (reference: s2.py:503-557)
    lum = dict(inv=None, u_lum=None, t_lum=None)
    if const.s2_luminescence_model == 'garfield_gas_gap':
        lum['t_lum'] = lumi_gasgap_times(
            params.gg_inv_cdf, *gasgap_rows(params, positions), ph_edges,
            draws['u_lum'], t_max=params.gg_t_max)
    elif const.s2_luminescence_model == 'garfield':
        lum['t_lum'] = lumi_garfield_times(
            params.garfield_t, params.garfield_x, positions, ph_edges,
            draws['col'], draws['u_wire'], avgt=params.garfield_avgt,
            tilt=const.anode_xaxis_angle, pitch=const.anode_pitch,
            confine=const.s2_garfield_confine_position)
    else:
        # gas-gap warping: each instruction's gas gap at its observed
        # position (wfsim_tpu s2.py:183-188)
        dG = None
        if const.enable_gas_gap_warping and params.gas_gap_map is not None:
            dG = _first(params.gas_gap_map(positions)).contiguous()
        lum['inv'] = luminescence_tables(const, n_inst, dev, dG)
        lum['u_lum'] = draws['u_lum']
    # the time term: the spread normal times s2_time_spread, or the optical
    # delay times 1 (exact in float32, so the kernel adds trunc(delay))
    t_spread, time_spread = draws['t_spread'], const.s2_time_spread
    if s2_time_mode(params, const) == 'optical':
        t_spread, time_spread = optical_delays(params, const, ch,
                                               draws['u_prop']), 1.0
    t, truth_row = s2_photon_times(
        lum['inv'], e_edges, e_ph_edges, e_t, inst['truth_row'],
        lum['u_lum'], draws['u_st'], draws['exp_st'], t_spread,
        singlet_fraction=const.singlet_fraction_gas,
        t_singlet=const.singlet_lifetime_gas,
        t_triplet=const.triplet_lifetime_gas,
        time_spread=time_spread, t_lum=lum['t_lum'])

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
    if const.field_distortion_model in ('inverse_fdc', 'comsol'):
        truth['x_mean_electron'], truth['y_mean_electron'] = \
            mean_electron_position(positions, inst['truth_row'], n_truth_rows)
    return photons, truth, ph_edges[1:] - ph_edges[:-1]


def simulate_s2(params, const, inst, gen, *, n_truth_rows: int):
    """Simulate a batch of S2 instructions: :func:`s2_draws`, then
    :func:`s2_photon_pass` (inst and returns as there)."""
    check_supported(const)
    return s2_photon_pass(params, const, inst,
                          s2_draws(params, const, inst, gen),
                          n_truth_rows=n_truth_rows)
