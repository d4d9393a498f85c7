"""S1 scintillation, ``simple``, ``custom``, ``nest`` and
``optical_propagation`` timing models (counterpart of
wfsim_tpu/models/s1.py simulate_s1, s1.py:143-228; reference:
wfsim/core/s1.py:60-238).

Detected photons per instruction are Binomial(amp, LCE/(1+p_dpe) * eff);
channels come from an inverse-CDF draw on the pattern map; times add, per
model, the optical propagation delay to the photon's array at the
instruction's depth (``optical_propagation``, from the S1 spline), an
exponential decay and a Gaussian spread (``simple``), the delay
of the instruction's recoil class (``custom``: ER excimers and
recombination, NR, alpha, LED) and a sample of the tabulated NEST
photon-time distribution of the instruction's recoil class, field and
energy (``nest``), then the PMT response.  The photon axis is allocated
at its exact size once the yields are drawn.

:func:`simulate_s1` is :func:`s1_draws`, which makes the yields and every
per-photon draw from the generator, followed by :func:`s1_photon_pass`, a
pure function of those draws.  On a CUDA device the pass runs the
hand-written kernels (photon times, custom and NEST delays, channel
draw, PMT response, map lookups); on the CPU their plain twins.
"""
from __future__ import annotations

import numpy as np
import torch

from .._build import Kernel, P, I, F, check_tensor, ptr, stream_of
from ..ops.randsample import (channel_draw, binomial, uniform, normal,
                              exponential)
from ..ops.segment import segment_ids_from_counts, edges_from_counts
from .common import (f32, singlet_triplet_delays, trunc_int, check_edges,
                     check_segments)
from .pmt import pmt_draws, pmt_response

__all__ = ['simulate_s1', 's1_draws', 's1_photon_pass', 's1_n_photon_hits',
           's1_photon_times', 's1_photon_times_ref', 'masked_pattern',
           'live_pattern', 'nest_inputs', 'optical_delays', 'optical_on',
           's1_models', 'recoil_class', 'grid_pos', 'nest_delays',
           'nest_delays_ref', 'NestId', 'custom_delays', 'custom_delays_ref',
           'CUSTOM_DRAWS']

#: the timing models of an ``s1_model_type`` string (wfsim_tpu
#: pipeline/rawdata.py:299-321), all of which the port runs
PORTED_S1_MODELS = frozenset({'simple', 'custom', 'optical_propagation',
                              'nest'})
S1_MODEL_PARTS = PORTED_S1_MODELS | {''}

#: the per-photon draws of the ``custom`` model, in wfsim_tpu's key order
#: (s1.py:56-96: keys 5-15 of the chain): the ER primary-excimer uniform,
#: the primary singlet/triplet pair (uniform, exponential), the
#: recombination uniform on [1e-12, 1), the secondary singlet/triplet pair,
#: the NR pair, the alpha pair and the LED uniform
CUSTOM_DRAWS = ('u_prim', 'u_st_prim', 'exp_st_prim', 'u_reco', 'u_st_sec',
                'exp_st_sec', 'u_nr', 'exp_nr', 'u_alpha', 'exp_alpha',
                'u_led')

#: the smallest recombination uniform (jax.random.uniform's minval there)
U_RECO_MIN = 1e-12


def s1_models(model: str) -> frozenset:
    """The timing models named by ``model``: its parts split at '+',
    spaces and commas, as wfsim_tpu validates them.  Raises ValueError on
    an unknown part."""
    parts = set()
    for part0 in str(model).split('+'):
        for part1 in part0.split(' '):
            parts.update(part1.split(','))
    bad = parts - S1_MODEL_PARTS
    if bad:
        raise ValueError(f'Model type {sorted(bad)} not in '
                         f'{sorted(S1_MODEL_PARTS)}')
    parts.discard('')
    return frozenset(parts)


class NestId:
    """NEST interaction-type ids per recoil class (reference: s1.py:21-30)."""
    NR = (0,)
    ALPHA = (6,)
    ER = (7, 8, 11, 12)
    LED = (20,)


def recoil_class(recoil: torch.Tensor) -> torch.Tensor:
    """0=ER, 1=NR, 2=alpha, 3=LED (ER where the id is none of these, like
    the reference's lookup; wfsim_tpu s1.py:33)."""
    cls = torch.zeros_like(recoil, dtype=torch.int64)
    for ids, c in ((NestId.NR, 1), (NestId.ALPHA, 2), (NestId.LED, 3)):
        for v in ids:
            cls = torch.where(recoil == v, c, cls)
    return cls


def grid_pos(axis: torch.Tensor, x: torch.Tensor):
    """Fractional position of x on a 1-d grid: (i0, i1, w), the lower
    search of ``axis`` clamped to [1, n-1] (wfsim_tpu s1.py:99)."""
    n = axis.shape[0]
    i1 = torch.clamp(torch.searchsorted(axis, x.contiguous()), 1, n - 1)
    i0 = i1 - 1
    w = (x - axis[i0]) / torch.clamp_min(axis[i1] - axis[i0], 1e-30)
    return i0, i1, torch.clamp(w, 0.0, 1.0)


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


def live_pattern(params, pattern):
    """(I, C) float32 pattern times the live mask; a (I,) pattern (a map
    with one output) is broadcast over the channels."""
    if pattern.dim() == 1:
        pattern = pattern[:, None] * torch.ones(
            (1, params.gains.shape[0]), device=pattern.device)
    return pattern * params.live_mask[None, :].to(pattern.dtype)


def masked_pattern(params, pattern_map, positions):
    """(I, C) float32 pattern of each instruction times the live mask."""
    return live_pattern(params, pattern_map(positions))


def _positions(inst):
    return torch.stack([inst['x'], inst['y'], inst['z']], dim=1)


def reco_uniform(u: torch.Tensor) -> torch.Tensor:
    """A [0, 1) uniform moved to [1e-12, 1) as ``jax.random.uniform(key,
    minval=1e-12, maxval=1.0)`` moves its own: ``max(1e-12, u * 1 +
    1e-12)`` in float32 (1 - 1e-12 rounds to 1), so ``1 / u`` is finite."""
    lo = f32(U_RECO_MIN, u)
    return torch.maximum(lo, u + lo)


def optical_on(params, models) -> bool:
    """Whether the photons take the optical propagation delay: the model
    is named and its spline loaded (wfsim_tpu s1.py:174)."""
    return 'optical_propagation' in models and params.s1_prop_top is not None


def s1_draws(params, const, inst, gen) -> dict:
    """The yields and per-photon draws of an S1 batch, in the generator's
    order: the binomial photon counts ``n_hits``, then per photon the
    channel uniform ``u_ch``, with ``optical_propagation`` timing (and its
    spline) the spline's uniform ``u_prop``, with ``simple`` timing the
    decay exponential
    ``exp`` and the spread normal ``normal``, with ``custom`` timing the
    dict ``custom`` of the eleven :data:`CUSTOM_DRAWS` (the recombination
    uniform through :func:`reco_uniform`), with ``nest`` timing the
    table uniform ``u_nest``, and the PMT draws ``pmt``
    (:func:`pmt_draws`).  A model that is off takes no draws (None)."""
    models = s1_models(const.s1_model_type)
    dev = inst['x'].device
    n_hits = s1_n_photon_hits(params, const, _positions(inst), inst['amp'],
                              gen)
    n = int(n_hits.sum())
    d = dict(n_hits=n_hits, u_ch=uniform(gen, n, dev), u_prop=None,
             exp=None, normal=None, custom=None, u_nest=None)
    if optical_on(params, models):
        d['u_prop'] = uniform(gen, n, dev)
    if 'simple' in models:
        d['exp'] = exponential(gen, n, dev)
        d['normal'] = normal(gen, n, dev)
    if 'custom' in models:
        d['custom'] = {k: (exponential(gen, n, dev) if k.startswith('exp')
                           else uniform(gen, n, dev)) for k in CUSTOM_DRAWS}
        d['custom']['u_reco'] = reco_uniform(d['custom']['u_reco'])
    if 'nest' in models:
        d['u_nest'] = uniform(gen, n, dev)
    d['pmt'] = pmt_draws(gen, n, dev)
    return d


# ---------------------------------------------------------------------------
# NEST photon delays (K13b)


def nest_delays_ref(table, cls, fi0, fi1, fw, ei0, ei1, ew, edges, u):
    """Plain twin of :func:`nest_delays`."""
    ph = segment_ids_from_counts(edges[1:] - edges[:-1])
    M = table.shape[-1]
    s = u * (M - 1)
    k0 = torch.floor(s).to(torch.int64)
    k1 = torch.clamp_max(k0 + 1, M - 1)
    kw = s - k0.to(torch.float32)
    c = cls[ph]
    out = 0.0
    for fi, fwgt in ((fi0[ph], 1 - fw[ph]), (fi1[ph], fw[ph])):
        for ei, ewgt in ((ei0[ph], 1 - ew[ph]), (ei1[ph], ew[ph])):
            q = table[c, fi, ei, k0] * (1 - kw) + table[c, fi, ei, k1] * kw
            out = out + fwgt * ewgt * q
    return out


_nest_kernel = Kernel('wfsim_nest_delays',
                      [P, I, I, I, I, P, P, P, P, P, P, P, I, P, P, I, P, P])


def nest_delays(table, cls, fi0, fi1, fw, ei0, ei1, ew, edges, u):
    """NEST photon emission delays (wfsim_tpu/models/s1.py:108
    _nest_table_delays): photon j of instruction i samples the (class,
    field, energy) quantile table at ``u[j] * (M-1)``, linear in the
    quantile and bilinear in field and energy, summed in the order (field
    lower, energy lower), (lower, upper), (upper, lower), (upper, upper).

    :param table: (4, F, En, M) float32 inverse CDFs
    :param cls: (I,) int64 recoil class (:func:`recoil_class`)
    :param fi0, fi1, fw: (I,) int64, int64, float32 :func:`grid_pos` of the
        instruction's field; ``ei0, ei1, ew`` the same of its energy
    :param edges: (I+1,) int64: instruction i owns photons [edges[i],
        edges[i+1]), ending at the photon total N
    :param u: (N,) float32 uniforms
    :returns: (N,) float32 delays (ns)

    CPU tensors run :func:`nest_delays_ref` and raise where the edges do
    not end at N; CUDA tensors launch ``csrc/table_samplers.cu`` (one
    launch, tiles of 1,024 photons a block), which clamps the edges to the
    photons (a photon past the last edge is not written) and reads nothing
    back."""
    dev = table.device
    n_inst = cls.shape[0]
    n = u.shape[0]
    check_tensor('table', table, torch.float32, table.shape, dev)
    if table.dim() != 4:
        raise ValueError(f'table of shape {tuple(table.shape)}')
    for name, x, dt in (('cls', cls, torch.int64), ('fi0', fi0, torch.int64),
                        ('fi1', fi1, torch.int64), ('fw', fw, torch.float32),
                        ('ei0', ei0, torch.int64), ('ei1', ei1, torch.int64),
                        ('ew', ew, torch.float32)):
        check_tensor(name, x, dt, (n_inst,), dev)
    check_tensor('edges', edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('u', u, torch.float32, (n,), dev)
    check_edges(edges, n, 'uniforms')
    check_segments(n, n_inst, 'uniforms')
    args = (table, cls, fi0, fi1, fw, ei0, ei1, ew, edges, u)
    if dev.type == 'cpu':
        return nest_delays_ref(*args)
    if dev.type != 'cuda':
        raise NotImplementedError(f'nest_delays on {dev}')
    if n >= 2 ** 31 or table.numel() >= 2 ** 31:
        raise ValueError(f'{n} photons, a table of {table.numel()}: the '
                         f'kernel indexes them as int')
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _nest_kernel(ptr(table), *table.shape, ptr(cls), ptr(fi0), ptr(fi1),
                     ptr(fw), ptr(ei0), ptr(ei1), ptr(ew), n_inst,
                     ptr(edges), ptr(u), n, ptr(out), stream_of(dev))
    return out


# ---------------------------------------------------------------------------
# custom recoil-class delays (K15)


def custom_delays_ref(cls, edges, draws, *, const):
    """Plain twin of :func:`custom_delays`: every class computed for every
    photon and one selected, as wfsim_tpu does."""
    ph = segment_ids_from_counts(edges[1:] - edges[:-1])
    c = cls[ph]
    d = draws
    t1, t3 = const.singlet_lifetime_liquid, const.triplet_lifetime_liquid

    def st(u, e, frac):
        return singlet_triplet_delays(u, e, frac, t1, t3).to(torch.float32)
    u = torch.clamp_min(d['u_reco'], f32(U_RECO_MIN, d['u_reco']))
    one = f32(1.0, u)
    reco = f32(const.er_recombination_time, u) * (-one + one / u)
    reco = torch.clamp(reco, 0.0, 1000.0)
    er = torch.where(d['u_prim'] < f32(const.er_primary_excimer_fraction, u),
                     st(d['u_st_prim'], d['exp_st_prim'],
                        const.s1_ER_primary_singlet_fraction),
                     reco + st(d['u_st_sec'], d['exp_st_sec'],
                               const.s1_ER_secondary_singlet_fraction))
    nr = st(d['u_nr'], d['exp_nr'], const.s1_NR_singlet_fraction)
    alpha = st(d['u_alpha'], d['exp_alpha'],
               const.s1_ER_alpha_singlet_fraction)
    led = d['u_led'] * f32(const.led_pulse_length, u)
    out = torch.where(c == 1, nr, er)
    out = torch.where(c == 2, alpha, out)
    return torch.where(c == 3, led, out)


_custom_kernel = Kernel('wfsim_s1_custom_delays',
                        [P, P, I, I] + [P] * len(CUSTOM_DRAWS) + [F] * 9
                        + [P, P])


def custom_delays(cls, edges, draws, *, const):
    """S1 photon delays of the ``custom`` timing model (wfsim_tpu
    models/s1.py:56 _custom_recoil_delays; reference s1.py:262-337), by the
    recoil class of the photon's instruction:

    - ER (class 0): with probability ``er_primary_excimer_fraction`` the
      primary singlet/triplet delay, else the recombination delay
      ``clip(er_recombination_time * (1/u - 1), 0, 1000)`` plus the
      secondary singlet/triplet delay;
    - NR (1) and alpha (2): their singlet/triplet delays;
    - LED (3): ``u * led_pulse_length``.

    A singlet/triplet delay is ``trunc(exp * lifetime)`` with the singlet
    lifetime where its uniform is below the class's singlet fraction, as a
    float.  The recombination uniform is clamped to at least 1e-12, as
    wfsim_tpu draws it.

    :param cls: (I,) int64 recoil class (:func:`recoil_class`)
    :param edges: (I+1,) int64: instruction i owns photons [edges[i],
        edges[i+1]), ending at the photon total N
    :param draws: dict of the (N,) float32 :data:`CUSTOM_DRAWS`
    :returns: (N,) float32 delays (ns)

    CPU tensors run :func:`custom_delays_ref` and raise where the edges do
    not end at N; CUDA tensors launch ``csrc/table_samplers.cu`` (one
    launch, tiles of 1,024 photons a block), which reads the draws of the
    photon's class only, clamps the edges to the photons (a photon past
    the last edge is not written) and reads nothing back."""
    dev = cls.device
    n_inst = cls.shape[0]
    check_tensor('cls', cls, torch.int64, (n_inst,), dev)
    check_tensor('edges', edges, torch.int64, (n_inst + 1,), dev)
    if set(draws) != set(CUSTOM_DRAWS):
        raise ValueError(f'custom draws {sorted(draws)}, expected '
                         f'{sorted(CUSTOM_DRAWS)}')
    n = draws[CUSTOM_DRAWS[0]].shape[0]
    for k in CUSTOM_DRAWS:
        check_tensor(k, draws[k], torch.float32, (n,), dev)
    check_edges(edges, n, 'custom draws')
    check_segments(n, n_inst, 'custom draws')
    if dev.type == 'cpu':
        return custom_delays_ref(cls, edges, draws, const=const)
    if dev.type != 'cuda':
        raise NotImplementedError(f'custom_delays on {dev}')
    if n >= 2 ** 31:
        raise ValueError(f'{n} photons: the kernel indexes them as int')
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        consts = (const.er_primary_excimer_fraction,
                  const.er_recombination_time,
                  const.s1_ER_primary_singlet_fraction,
                  const.s1_ER_secondary_singlet_fraction,
                  const.s1_NR_singlet_fraction,
                  const.s1_ER_alpha_singlet_fraction,
                  const.singlet_lifetime_liquid,
                  const.triplet_lifetime_liquid, const.led_pulse_length)
        _custom_kernel(ptr(cls), ptr(edges), n_inst, n,
                       *(ptr(draws[k]) for k in CUSTOM_DRAWS),
                       *(float(np.float32(v)) for v in consts), ptr(out),
                       stream_of(dev))
    return out


# ---------------------------------------------------------------------------
# photon times (K9)


def s1_photon_times_ref(time, edges, truth_row, exp, nrm, nest=None,
                        custom=None, *, decay_time, decay_spread):
    """Plain twin of :func:`s1_photon_times` (the edges give the photon
    total)."""
    ph_inst = segment_ids_from_counts(edges[1:] - edges[:-1])
    t = time[ph_inst]
    if exp is not None:
        t = t + trunc_int(exp * decay_time)
        t = t + trunc_int(nrm * decay_spread)
    if custom is not None:
        t = t + trunc_int(custom)
    if nest is not None:
        t = t + trunc_int(nest)
    return t, truth_row[ph_inst]


_times_kernel = Kernel('wfsim_s1_photon_times',
                       [P, P, P, I, I, P, P, P, P, F, F, P, P, P])


def s1_photon_times(time, edges, truth_row, exp, nrm, nest=None,
                    custom=None, *, decay_time, decay_spread,
                    n_photons=None):
    """Photon times of the S1 timing models (reference: s1.py:191-234):
    ``time[i]``, plus ``trunc(exp * decay_time) + trunc(normal *
    decay_spread)`` with ``simple`` timing (``exp`` and ``nrm`` given),
    ``trunc(custom)`` with ``custom`` timing (:func:`custom_delays`) and
    ``trunc(nest)`` with ``nest`` timing (:func:`nest_delays`), in
    wfsim_tpu's order, for the photons [edges[i], edges[i+1]) of
    instruction i.

    :param n_photons: the photon total N where none of ``exp``, ``custom``
        and ``nest`` is given (an ``s1_model_type`` with no timing part);
        else their length, which ``n_photons`` must equal where given
    :returns: (t (N,) int32, truth row (N,) int64)

    CPU tensors run :func:`s1_photon_times_ref` and raise where the edges
    do not end at N; CUDA tensors launch ``csrc/photon_times.cu`` once
    (a block an instruction for its first 256 photons, tiles of 256
    photons for the rest), which clamps the edges to the photons (a photon
    past the last edge is not written) and reads nothing back."""
    dev = time.device
    n_inst = time.shape[0]
    given = [x for x in (exp, custom, nest) if x is not None]
    if n_photons is None and not given:
        raise ValueError('s1_photon_times without exp, custom or nest '
                         'draws takes the photon total n_photons')
    n = int(n_photons) if n_photons is not None else given[0].shape[0]
    check_tensor('time', time, torch.int32, (n_inst,), dev)
    check_tensor('edges', edges, torch.int64, (n_inst + 1,), dev)
    check_tensor('truth_row', truth_row, torch.int64, (n_inst,), dev)
    if (exp is None) != (nrm is None):
        raise ValueError('the simple model takes both exp and normal draws')
    for name, x in (('exp', exp), ('normal', nrm), ('nest', nest),
                    ('custom', custom)):
        if x is not None:
            check_tensor(name, x, torch.float32, (n,), dev)
    check_edges(edges, n, 'S1 photon times')
    check_segments(n, n_inst, 'S1 photon times')
    kw = dict(decay_time=decay_time, decay_spread=decay_spread)
    if dev.type == 'cpu':
        return s1_photon_times_ref(time, edges, truth_row, exp, nrm, nest,
                                   custom, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f's1_photon_times on {dev}')
    if n >= 2 ** 31:
        raise ValueError(f'{n} photons: the kernel indexes them as int')
    t = torch.empty(n, dtype=torch.int32, device=dev)
    ph_row = torch.empty(n, dtype=torch.int64, device=dev)

    def opt(x):
        return None if x is None else ptr(x)
    if n:
        _times_kernel(ptr(time), ptr(edges), ptr(truth_row), n_inst, n,
                      opt(exp), opt(nrm), opt(nest), opt(custom),
                      float(np.float32(decay_time)),
                      float(np.float32(decay_spread)), ptr(t), ptr(ph_row),
                      stream_of(dev))
    return t, ph_row


def nest_inputs(params, const, inst):
    """The per-instruction inputs of :func:`nest_delays`: the table, the
    recoil class and the grid positions of the local field and the energy
    (the drift field and 10 keV where the batch has none; wfsim_tpu
    s1.py:193-201)."""
    x = inst['x']
    fld = inst.get('local_field')
    if fld is None:
        fld = torch.full_like(x, const.drift_field)
    edep = inst.get('e_dep')
    if edep is None:
        edep = torch.full_like(x, 10.0)
    fi0, fi1, fw = grid_pos(params.nest_fields, fld)
    ei0, ei1, ew = grid_pos(params.nest_energies, edep)
    return (params.nest_inv_cdf, recoil_class(inst['recoil']), fi0, fi1, fw,
            ei0, ei1, ew)


def optical_delays(params, const, z, n_hits, ch, u):
    """The S1 photons' optical propagation delays (wfsim_tpu s1.py:174-181;
    reference s1.py:176-189): both splines at (the photon's instruction's
    z, its uniform ``u``), the top one for a top-array channel (``ch <
    n_top_pmts``, a photon without a channel included, as there), float32
    (N,).  The photon total is ``u``'s length, so the card reads nothing
    back."""
    z_ph = torch.repeat_interleave(z, n_hits.to(torch.int64),
                                   output_size=u.shape[0])
    pts = torch.stack([z_ph, u], dim=1)
    top, bottom = params.s1_prop_top(pts), params.s1_prop_bottom(pts)
    if top.dim() > 1:
        top, bottom = top[..., 0], bottom[..., 0]
    return torch.where(ch < const.n_top_pmts, top, bottom)


def s1_photon_pass(params, const, inst, draws, *, n_truth_rows: int):
    """The S1 photons and truth of a batch given its draws
    (:func:`s1_draws`); a pure function of its arguments.

    :param inst: dict of (I,) tensors: time (int32, batch-relative ns), x, y,
        z (float32), amp (int32), truth_row (int64, ascending); for
        ``custom`` and ``nest`` timing also recoil (int32), for ``nest``
        local_field and e_dep (float32)
    :returns: (photons, truth, req_counts) — ``req_counts`` (I,) is each
        instruction's photon count; photons are grouped by instruction

    The photon times take the photon total from the draws' length
    (``u_ch``), so on a CUDA device they read nothing back.
    """
    models = s1_models(const.s1_model_type)
    n_hits = draws['n_hits']
    n = draws['u_ch'].shape[0]
    inst_edges = edges_from_counts(n_hits)
    # channels from the pattern map (reference: s1.py:137-159)
    ch = channel_draw(masked_pattern(params, params.s1_pattern,
                                     _positions(inst)),
                      inst_edges, draws['u_ch'])
    custom = nest = None
    if 'custom' in models:
        custom = custom_delays(recoil_class(inst['recoil']), inst_edges,
                               draws['custom'], const=const)
    if 'nest' in models:
        nest = nest_delays(*nest_inputs(params, const, inst), inst_edges,
                           draws['u_nest'])
    t, truth_row = s1_photon_times(
        inst['time'], inst_edges, inst['truth_row'], draws['exp'],
        draws['normal'], nest, custom, decay_time=const.s1_decay_time,
        decay_spread=const.s1_decay_spread, n_photons=n)
    if optical_on(params, models):
        t = t + trunc_int(optical_delays(params, const, inst['z'], n_hits,
                                         ch, draws['u_prop']))
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
    return s1_photon_pass(params, const, inst,
                          s1_draws(params, const, inst, gen),
                          n_truth_rows=n_truth_rows)
