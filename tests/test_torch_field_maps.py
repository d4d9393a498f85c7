"""The ``field_maps`` configuration of wfsim_tpu_torch (S1 and S2 optical
propagation splines, COMSOL field distortion, gas-gap warping of the
``simple`` luminescence, every field-dependency map, the se-gain and
extraction maps) against wfsim_tpu on the CPU, both packages reading the
same synthetic map files (``resources.synthetic.write_field_maps``).

Tolerances, per quantity:

- the parameter bundle: bitwise (every new map field, carried across by
  ``params_from_numpy`` from wfsim_tpu's bundle); the constants: equal;
- map lookups (the (r, z) maps through ``rz_lookup``, the (x, y) gas-gap
  and se-gain maps, the spline delays, the drift time mean and spread,
  the light yield, the extraction probability, the diffusion sigmas):
  rtol 1e-6 (wfsim_tpu's jitted lookup may contract a multiply-add);
- COMSOL positions: rtol 1e-6 / atol 1e-6 cm (F12: the port rotates by x
  / r and y / r, wfsim_tpu by cos and sin of arctan2), except the y of a
  point on the negative x axis: 0 here, r sin(float32 pi) there;
- the diffused pattern (sigmas from the maps): rtol 1e-5, as truth sums
  (wfsim_tpu sums the electrons' patterns in float32, the port in
  float64);
- integer photon times and channels given the same draws: the spline
  delays truncated to ints bitwise against wfsim_tpu's lookup run without
  jit; whole passes as in tests/test_torch_photon_passes.py (channels
  equal except targets within 1e-6 of a CDF edge, counted; times
  ``trunc_mismatch``: at most 1 in 10^3 photons off by exactly 1 ns, the
  luminescence tables being float32 sums in wfsim_tpu and float64 ones
  here);
- truth sums: as in tests/test_torch_physics.py (rtol 1e-5; min and max
  times within 1 ns; the mean electron position within 1e-5 cm); a row
  without photons (its electrons all outside the TPC) 0 here and within
  2^-23 of the batch's total in wfsim_tpu (a float32 running sum);
- distributions: a one-sample KS test of a spline delay against the
  map's own inverse, p > 0.01.
"""
import dataclasses
import unittest.mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.stats import kstest

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models import s1 as js1, s2 as js2
from wfsim_tpu.models.common import rz_lookup as jax_rz_lookup
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import Simulator
from wfsim_tpu_torch.config import default_config, field_maps_overrides
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.models import s1, s2
from wfsim_tpu_torch.models.common import rz_lookup
from wfsim_tpu_torch.models.params import (build_params, build_constants,
                                           params_from_numpy)
from wfsim_tpu_torch.ops import randsample as rs
from wfsim_tpu_torch.resources import load_config
from wfsim_tpu_torch.resources.loader import Resource
from wfsim_tpu_torch.resources.synthetic import (write_field_maps,
                                                 FIELD_MAP_FILES)

from .test_torch_host import export_jax_params
from .test_torch_photon_passes import (jax_inst, port_inst, _np,
                                       _jax_pmt_draws, channels_agree,
                                       compare_truth, t32)
from .test_torch_physics import trunc_mismatch

#: the SimParams fields this configuration adds
MAP_FIELDS = ('fd_comsol', 'drift_speed_map', 'survival_prob_map',
              'diffusion_long_map', 'diffusion_radial_map',
              'diffusion_azimuthal_map', 'gas_gap_map', 'se_gain',
              's1_prop_top', 's1_prop_bottom', 's2_prop_top',
              's2_prop_bottom')
#: the (r, z) maps looked up through rz_lookup
RZ_MAPS = ('fd_comsol', 'drift_speed_map', 'survival_prob_map',
           'diffusion_long_map', 'diffusion_radial_map',
           'diffusion_azimuthal_map')
N_INST = 24


@pytest.fixture(scope='module')
def maps_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('field_maps')
    write_field_maps(d, 19)
    return d


@pytest.fixture(scope='module')
def bundles(maps_dir):
    """Both packages' bundles of ``field_maps`` (JAX's also through
    ``params_from_numpy``)."""
    over = field_maps_overrides(maps_dir)
    cj = jax_default_config(**over)
    pj = jax_build_params(cj, jax_load_config(cj))
    kj = jax_build_constants(cj)
    c = default_config(**over)
    pt = build_params(c, load_config(c), 'cpu')
    kt = build_constants(c)
    conv, _ = params_from_numpy(export_jax_params(pj),
                                dataclasses.asdict(kj), 'cpu')
    return pj, kj, pt, kt, conv


@pytest.fixture(scope='module')
def positions():
    """Instruction positions over and past the maps: r up to 60 cm (the
    maps reach 70, the TPC 50), z in [-140, -5] (the maps reach -100),
    plus r = 0 and points on the map edges; JAX and port copies."""
    ji = jax_inst(N_INST, 300, 21)
    ji['x'][:3] = np.float32([0.0, 70.0, -49.5])
    ji['y'][:3] = np.float32([0.0, 0.0, 0.0])
    ji['z'][:3] = np.float32([-50.0, 0.0, -100.0])
    xy = np.stack([ji['x'], ji['y']], 1)
    return (ji, jnp.asarray(ji['z']), jnp.asarray(xy), t32(ji['z']),
            t32(xy))


def _close(a, b, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# the bundle


@pytest.mark.parametrize('field', MAP_FIELDS)
def test_map_fields_match_jax(bundles, field):
    """Each new map, as the port loads it and as ``params_from_numpy``
    carries it across from wfsim_tpu's bundle: bitwise."""
    pj, _kj, pt, _kt, conv = bundles
    assert getattr(pj, field) is not None
    for part in ('values', 'lows', 'highs'):
        a = getattr(getattr(pt, field), part).numpy()
        np.testing.assert_array_equal(_bits(a), _bits(getattr(
            getattr(conv, field), part).numpy()))
        np.testing.assert_array_equal(_bits(a), _bits(getattr(
            getattr(pj, field), part)))


def test_constants_match_jax(bundles):
    """The constants, the ``norm_drift_velocity`` scaling from the drift
    speed at (0, -tpc_length) among them, equal."""
    _pj, kj, _pt, kt, _conv = bundles
    assert dataclasses.asdict(kj) == dataclasses.asdict(kt)
    assert 0.8 < kt.drift_velocity_scaling < 1.1
    assert kt.en_drift_speed and kt.en_diff_long and kt.en_diff_trans \
        and kt.en_survival_prob


def test_dummy_maps_match_jax():
    """The constant dummies: the field-dependency maps become four
    constant (r, z) maps, the S1 spline a 2-d and the S2 spline a 1-d
    constant (wfsim_tpu builds it 2-d; ``params_from_numpy`` takes it to
    1-d); bitwise their JAX values."""
    over = dict(s1_model_type='optical_propagation+simple',
                s2_time_model='optical_propagation',
                s1_time_spline=['constant dummy', 7.5, []],
                s2_time_spline=['constant dummy', 4.25, []],
                enable_field_dependencies={'drift_speed_map': True,
                                           'diffusion_transverse_map': True},
                field_dependencies_map=['constant dummy', 1.4, []])
    cj = jax_default_config(**over)
    pj = jax_build_params(cj, jax_load_config(cj))
    kj = jax_build_constants(cj)
    c = default_config(**over)
    pt = build_params(c, load_config(c), 'cpu')
    conv, _ = params_from_numpy(export_jax_params(pj),
                                dataclasses.asdict(kj), 'cpu')
    assert pt.s2_prop_top.ndim_in == conv.s2_prop_top.ndim_in == 1
    assert pj.s2_prop_top.values.ndim == 3
    for field in ('drift_speed_map', 'survival_prob_map',
                  'diffusion_radial_map', 'diffusion_azimuthal_map',
                  's1_prop_top', 's1_prop_bottom', 's2_prop_top',
                  's2_prop_bottom'):
        for part in ('values', 'lows', 'highs'):
            np.testing.assert_array_equal(
                getattr(getattr(pt, field), part).numpy(),
                getattr(getattr(conv, field), part).numpy())
    u = torch.rand(100, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(
        s2.optical_delays(pt, build_constants(c), torch.zeros(100, dtype=
                                                              torch.int32),
                          u).numpy(), np.float32(4.25))
    assert dataclasses.asdict(build_constants(c)) == dataclasses.asdict(kj)
    assert kj.drift_velocity_scaling == 1.0   # no norm_drift_velocity


# ---------------------------------------------------------------------------
# per function, against wfsim_tpu


@pytest.mark.parametrize('field', RZ_MAPS)
def test_rz_lookup_matches_jax(bundles, positions, field):
    pj, _kj, pt, _kt, _conv = bundles
    _ji, zj, xyj, zt, xyt = positions
    got = rz_lookup(getattr(pt, field), zt, xyt).numpy()
    want = np.asarray(jax_rz_lookup(getattr(pj, field), zj, xyj))
    _close(got, want.reshape(got.shape))


def test_xy_maps_match_jax(bundles, positions):
    """The gas-gap and se-gain maps over (x, y)."""
    pj, _kj, pt, _kt, _conv = bundles
    _ji, _zj, xyj, _zt, xyt = positions
    for field in ('gas_gap_map', 'se_gain'):
        _close(getattr(pt, field)(xyt).numpy(),
               np.asarray(getattr(pj, field)(xyj)))


def test_field_distortion_comsol_matches_jax(bundles, positions):
    pj, _kj, pt, _kt, _conv = bundles
    ji, zj, xyj, zt, xyt = positions
    z_j, pos_j = js2.field_distortion_comsol(pj, xyj[:, 0], xyj[:, 1], zj)
    z_t, pos_t = s2.field_distortion_comsol(pt, xyt[:, 0], xyt[:, 1], zt)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    # on the negative x axis wfsim_tpu's sin(arctan2(0, x)) is the float32
    # sin of float32 pi, 8.7e-8 (x / r is exact there: y = 0)
    neg_x = (ji['y'] == 0) & (ji['x'] < 0)
    assert neg_x.sum() == 1
    pos_j = np.asarray(pos_j)
    _close(pos_t.numpy()[~neg_x], pos_j[~neg_x], atol=1e-6)
    _close(pos_t.numpy()[neg_x, 0], pos_j[neg_x, 0])
    assert pos_t[neg_x, 1] == 0
    assert np.all(np.abs(pos_j[neg_x, 1]) <= 1e-7 * 50)
    # r = 0 gives (r_obs, 0), as arctan2(0, 0) = 0 does; and r_obs < r
    assert pos_t[0, 1] == 0 and pos_t[0, 0] == pt.fd_comsol(
        torch.tensor([[0.0, -50.0]]))[0]
    r = np.hypot(ji['x'], ji['y'])
    r_obs = np.hypot(*pos_t.numpy().T)
    assert np.all(r_obs[1:] < r[1:])
    # the pass's positions are COMSOL's
    x = port_inst(ji)
    _z, pos = s2.s2_positions(pt, _kt, x)
    np.testing.assert_array_equal(pos.numpy(), pos_t.numpy())


def test_drift_time_params_match_jax(bundles, positions):
    pj, kj, pt, kt, _conv = bundles
    _ji, zj, xyj, zt, xyt = positions
    mj, sj = js2.get_s2_drift_time_params(pj, kj, zj, xyj)
    mt, st = s2.get_s2_drift_time_params(pt, kt, zt, xyt)
    _close(mt.numpy(), mj)
    _close(st.numpy(), sj)
    vt = s2.get_avg_drift_velocity(pt, kt, zt, xyt).numpy()
    _close(vt, js2.get_avg_drift_velocity(pj, kj, zj, xyj))
    # the map's velocity, scaled to the configured one at the cathode
    assert np.ptp(vt) > 0.05 * vt.mean()


def test_yields_match_jax(bundles, positions):
    """The light yield (the se-gain map) and the electron's extraction x
    lifetime x survival probability (g2 over the se gain, the survival
    map), the latter taken from wfsim_tpu's binomial call."""
    pj, kj, pt, kt, _conv = bundles
    ji, zj, xyj, zt, xyt = positions
    _close(s2.get_s2_light_yield(pt, kt, xyt).numpy(),
           js2.get_s2_light_yield(pj, kj, xyj))
    with unittest.mock.patch.object(js2, 'binomial',
                                    lambda key, n, p: p):
        pj_prob = js2.get_electron_yield(pj, kj, jax.random.key(0),
                                         jnp.asarray(ji['amp']), xyj, zj,
                                         xyj)
    pt_prob = s2.electron_yield_probability(pt, kt, zt, xyt, xyt).numpy()
    _close(pt_prob, pj_prob)
    assert 0 < pt_prob.min() and pt_prob.max() < 0.6


def test_warped_luminescence_matches_jax(bundles, positions):
    """Each instruction's gas gap from the map at its observed position
    into the luminescence tables (K6's ``dG``): the photons' times against
    wfsim_tpu's ``luminescence_simple``, given the same uniforms."""
    pj, kj, pt, kt, _conv = bundles
    ji, zj, xyj, zt, xyt = positions
    _z, pos_t = s2.s2_positions(pt, kt, port_inst(ji))
    pos_j = jnp.asarray(pos_t.numpy())
    rng = np.random.default_rng(4)
    n = 30_000
    ph_inst = np.sort(rng.integers(0, N_INST, n)).astype(np.int32)
    key = jax.random.key(5)
    u = np.asarray(jax.random.uniform(key, (n,)))
    tj = np.asarray(js2.luminescence_simple(pj, kj, key, pos_j,
                                            jnp.asarray(ph_inst),
                                            jnp.ones(n, bool)))
    dG = pt.gas_gap_map(pos_t).contiguous()
    assert float(dG.min()) < float(dG.max())
    inv = s2.luminescence_tables(kt, N_INST, 'cpu', dG)
    assert not s2.lumi_sequential_rows_ref(kt, N_INST, 'cpu', dG).any()
    tt = s2.luminescence_simple(inv, t32(ph_inst), t32(u)).numpy()
    ok = np.float32(u) * np.float32(s2.Q - 1) < np.float32(s2.Q - 1)
    trunc_mismatch(tj[ok], tt[ok])
    # the warped gaps move the tables: not those of the constant gap
    flat = s2.luminescence_tables(kt, N_INST, 'cpu')
    assert not torch.equal(inv, flat)


def test_diffusion_sigmas_match_jax(bundles, positions):
    """The radial and azimuthal spreads from the diffusion maps and the
    drift speed map at the observed position (wfsim_tpu s2.py:309-318,
    written out with its own functions)."""
    pj, kj, pt, kt, _conv = bundles
    _ji, zj, xyj, zt, xyt = positions
    v = js2.get_avg_drift_velocity(pj, kj, zj, xyj)
    mean = jnp.maximum(-zj / v, 0.0)
    sr, sa, cos_t, sin_t = s2.diffusion_inputs(pt, kt, zt, xyt)
    for got, m in ((sr, pj.diffusion_radial_map),
                   (sa, pj.diffusion_azimuthal_map)):
        d = jax_rz_lookup(m, zj, xyj) * 1e-9
        _close(got.numpy(), jnp.sqrt(2 * d * mean))
    assert not torch.equal(sr, sa)
    theta = np.arctan2(np.asarray(xyj[:, 1]), np.asarray(xyj[:, 0]))
    _close(cos_t.numpy(), np.cos(theta), atol=1e-6)
    _close(sin_t.numpy(), np.sin(theta), atol=1e-6)


def test_spline_delays_match_jax(bundles):
    """The S1 (z, u) and S2 (u) spline delays given wfsim_tpu's uniforms
    and channels: floats rtol 1e-6 against its jitted lookup, the
    truncated ints bitwise against its lookup without jit."""
    pj, kj, pt, kt, _conv = bundles
    rng = np.random.default_rng(8)
    n_hits = rng.integers(0, 400, N_INST).astype(np.int32)
    n = int(n_hits.sum())
    z = rng.uniform(-120, 5, N_INST).astype(np.float32)
    ch = rng.integers(-1, 494, n).astype(np.int32)
    u = np.asarray(jax.random.uniform(jax.random.key(9), (n,)))
    zs = np.repeat(z, n_hits)
    is_top = jnp.asarray(ch) < kj.n_top_pmts

    def jax_s1(p):
        pts = jnp.stack([jnp.asarray(zs), jnp.asarray(u)], axis=1)
        return jnp.where(is_top, p.s1_prop_top(pts), p.s1_prop_bottom(pts))

    def jax_s2(p):
        ur = jnp.asarray(u)[:, None]
        return jnp.where(is_top, p.s2_prop_top(ur), p.s2_prop_bottom(ur))

    got1 = s1.optical_delays(pt, kt, t32(z), t32(n_hits), t32(ch), t32(u))
    got2 = s2.optical_delays(pt, kt, t32(ch), t32(u))
    for got, fn in ((got1, jax_s1), (got2, jax_s2)):
        _close(got.numpy(), fn(pj))
        with jax.disable_jit():
            want = np.asarray(js1.trunc_int(fn(pj)))
        np.testing.assert_array_equal(s1.trunc_int(got).numpy(), want)
        assert 1.0 < got.float().mean() < 30.0 and got.min() >= 0.0


def test_ks_spline_delay_against_its_inverse(bundles):
    """An S2 photon's delay on the bottom array, drawn through the port's
    spline lookup from torch uniforms, against the distribution the map
    defines: its CDF at t is the quantile u where the map's piecewise
    linear delay(u) reaches t (the map's own inverse)."""
    _pj, _kj, pt, kt, _conv = bundles
    n = 40_000
    u = torch.rand(n, generator=torch.Generator().manual_seed(23))
    d = s2.optical_delays(pt, kt, torch.full((n,), 493, dtype=torch.int32),
                          u).numpy().astype(np.float64)
    g = pt.s2_prop_bottom
    vals = g.values[:, 0].numpy().astype(np.float64)
    u_axis = np.linspace(float(g.lows[0]), float(g.highs[0]), len(vals))
    assert np.all(np.diff(vals) > 0)
    res = kstest(d, lambda t: np.interp(t, vals, u_axis))
    assert res.pvalue > 0.01, res


# ---------------------------------------------------------------------------
# the passes, given wfsim_tpu's draws


@pytest.fixture(scope='module')
def s1_case(bundles):
    """wfsim_tpu's S1 pass on a few dozen instructions, and its draws."""
    pj, kj, _pt, _kt, _conv = bundles
    ji = jax_inst(N_INST, 40_000, 31)
    jinst = {k: jnp.asarray(v) for k, v in ji.items()}
    key = jax.random.key(33)
    keys = jax.random.split(key, js1.N_S1_KEYS)
    pos = jnp.stack([jinst['x'], jinst['y'], jinst['z']], axis=1)
    n_hits = js1.s1_n_photon_hits(pj, kj, pos, jinst['amp'], jinst['valid'],
                                  keys[0])
    n = int(n_hits.sum())
    phj, trj, _ = js1.simulate_s1(pj, kj, jinst, key, capacity=n,
                                  n_truth_rows=N_INST)
    draws = _np(dict(n_hits=n_hits, u_ch=jax.random.uniform(keys[1], (n,)),
                     u_prop=jax.random.uniform(keys[2], (n,)),
                     exp=jax.random.exponential(keys[3], (n,)),
                     normal=jax.random.normal(keys[4], (n,)),
                     pmt=_jax_pmt_draws(keys[17:21], n)))
    return ji, phj, trj, draws


def test_s1_pass_matches_jax_given_draws(bundles, s1_case):
    _pj, _kj, pt, kt, _conv = bundles
    ji, phj, trj, draws = s1_case
    n = int(draws['u_ch'].shape[0])
    pht, trt, req = s1.s1_photon_pass(pt, kt, port_inst(ji), draws,
                                      n_truth_rows=N_INST)
    assert n > 5000 and int(req.sum()) == n
    pattern = s1.masked_pattern(pt, pt.s1_pattern, torch.stack(
        [t32(ji['x']), t32(ji['y']), t32(ji['z'])], 1)).numpy()
    channels_agree(np.asarray(phj['ch']), pht['ch'].numpy(),
                   np.asarray(jnp.cumsum(jnp.asarray(pattern), axis=1)),
                   rs.cumsum_f64(t32(pattern), 1).numpy(),
                   np.repeat(np.arange(N_INST), draws['n_hits'].numpy()),
                   draws['u_ch'].numpy())
    trunc_mismatch(phj['t'], pht['t'])
    for k in ('is_dpe', 'valid'):
        np.testing.assert_array_equal(np.asarray(phj[k]), pht[k].numpy(), k)
    compare_truth(trj, trt, N_INST)
    # the delays moved the times: not those of simple timing alone
    d = dict(draws, u_prop=None)
    plain, _tr, _req = s1.s1_photon_pass(
        pt, dataclasses.replace(kt, s1_model_type='simple'), port_inst(ji),
        d, n_truth_rows=N_INST)
    assert (pht['t'] - plain['t']).float().mean() > 1.0


@pytest.fixture(scope='module')
def s2_case(bundles):
    """wfsim_tpu's S2 pass on a few dozen instructions, and its draws."""
    pj, kj, _pt, _kt, _conv = bundles
    ji = jax_inst(N_INST, 300, 36)
    jinst = {k: jnp.asarray(v) for k, v in ji.items()}
    key = jax.random.key(37)
    keys = jax.random.split(key, js2.N_S2_KEYS)
    # without jit, wfsim_tpu's map lookups contract no multiply-add, so
    # they give the port's bits: an electron's time then differs only
    # where the float64 and float32 sums do
    with jax.disable_jit():
        st = js2._s2_electron_stage(pj, kj, jinst, keys, e_capacity=16384)
        E = int(st['total_e'])
        st = js2._s2_electron_stage(pj, kj, jinst, keys, e_capacity=E)
        n = int(st['n_ph_per_e'].sum())
        phj, trj, _ = js2.simulate_s2(pj, kj, jinst, key, e_capacity=E,
                                      capacity=n, n_truth_rows=N_INST)
    pos_j = js2.field_distortion_comsol(pj, jinst['x'], jinst['y'],
                                        jinst['z'])[1]
    pat_j = np.asarray(js2.s2_pattern_map_diffuse(
        pj, kj, (keys[8], keys[9]), st['n_electron'], jinst['z'], pos_j,
        st['e_inst'], st['e_valid']))
    draws = _np(dict(
        n_electron=st['n_electron'],
        e_exp=jax.random.exponential(keys[1], (E,)),
        e_normal=jax.random.normal(keys[2], (E,)),
        n_ph_per_e=st['n_ph_per_e'],
        diff_r=jax.random.normal(keys[8], (E,)),
        diff_a=jax.random.normal(keys[9], (E,)),
        u_ch=jax.random.uniform(keys[5], (n,)),
        u_lum=jax.random.uniform(keys[10], (n,)),
        u_st=jax.random.uniform(keys[12], (n,)),
        exp_st=jax.random.exponential(keys[13], (n,)),
        u_prop=jax.random.uniform(keys[14], (n,)),
        pmt=_jax_pmt_draws(keys[15:19], n)))
    draws.update(t_spread=None, aft_u0=None, aft_v=None,
                 diff_split=int(s2.diffuse_chunks(draws['n_electron'])))
    return ji, phj, trj, draws, pat_j


def test_s2_pass_matches_jax_given_draws(bundles, s2_case):
    _pj, _kj, pt, kt, _conv = bundles
    ji, phj, trj, draws, pat_j = s2_case
    x = port_inst(ji)
    draws = dict(draws)
    draws.update(zip(('z_obs', 'xy_obs'), s2.s2_positions(pt, kt, x)))
    n = int(draws['u_ch'].shape[0])
    pht, trt, req = s2.s2_photon_pass(pt, kt, x, draws, n_truth_rows=N_INST)
    assert n > 10000 and int(req.sum()) == n
    np.testing.assert_array_equal(np.asarray(trj['n_electron']),
                                  trt['n_electron'].numpy())
    assert np.all(draws['u_lum'].numpy() * np.float32(s2.Q - 1)
                  < np.float32(s2.Q - 1))

    # the diffused pattern (sigmas from the maps)
    e_edges, _e_ph, ph_edges = s2.s2_edges(draws)
    z_t, pos_t = draws['z_obs'], draws['xy_obs']
    pat_t = s2.pattern_diffuse(
        pt.s2_pattern, pos_t[:, 0].contiguous(), pos_t[:, 1].contiguous(),
        *s2.diffusion_inputs(pt, kt, z_t, pos_t), kt.tpc_radius ** 2,
        e_edges, draws['diff_r'], draws['diff_a'], 494).numpy()
    _close(pat_t, pat_j, rtol=1e-5)

    # channels: equal wherever the port's target u * total lies farther
    # than 1e-6 * total from every edge of the port's CDF
    pat_st = s2.s2_pattern(pt, kt, z_t, pos_t, e_edges, draws)
    cdf = rs.cumsum_f64(pat_st, 1).numpy().astype(np.float64)
    ph_inst = np.repeat(np.repeat(np.arange(N_INST),
                                  draws['n_electron'].numpy()),
                        draws['n_ph_per_e'].numpy())
    total = cdf[ph_inst, -1]
    target = draws['u_ch'].numpy() * total
    # (an instruction whose electrons all left the TPC has no mass: its
    # photons get no channel in either package)
    near = (np.array([np.abs(cdf[i] - v).min() for i, v in
                      zip(ph_inst, target)]) <= 1e-6 * total) & (total > 0)
    chj, cht = np.asarray(phj['ch']), pht['ch'].numpy()
    assert 0 < (cht < 0).sum() < 0.5 * n
    np.testing.assert_array_equal(chj[~near], cht[~near])
    assert (chj != cht).sum() <= near.sum() <= 2e-3 * n

    for k in ('is_dpe', 'valid'):
        np.testing.assert_array_equal(np.asarray(phj[k]), pht[k].numpy(), k)
    # a photon without a channel is not valid; wfsim_tpu zeroes its
    # luminescence time, the port does not (no stage reads it)
    valid = pht['valid'].numpy()
    trunc_mismatch(np.asarray(phj['t'])[valid], pht['t'].numpy()[valid])
    # rows whose electrons all left the TPC have no photon: 0 here; in
    # wfsim_tpu, which differences a float32 running sum over the rows,
    # within 2^-23 of the batch's total
    lit = trt['n_photon'].numpy() > 0
    assert 0 < (~lit).sum() < N_INST // 2
    compare_truth({k: np.asarray(v)[lit] for k, v in trj.items()},
                  {k: v[torch.from_numpy(lit)] for k, v in trt.items()},
                  int(lit.sum()))
    for k in ('n_photon', 'n_pe', 'raw_area', 'raw_area_trigger'):
        assert not trt[k][torch.from_numpy(~lit)].any(), k
        slack = 2.0 ** -23 * np.abs(np.asarray(trj[k])).sum()
        assert np.abs(np.asarray(trj[k])[~lit]).max() <= slack, k
    for k in ('electron_count', 'electron_t_min', 'electron_t_max'):
        _close(trt[k].numpy(), trj[k], rtol=0, atol=1)
    for k in ('x_mean_electron', 'y_mean_electron'):
        _close(trt[k].numpy(), trj[k], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# draw order


def test_field_maps_draw_order(bundles):
    """simulate_s1 and simulate_s2 of field_maps equal their passes over
    draws made in this order: S1 counts, channel uniforms, the spline's
    uniforms (JAX's key slot 2, before ``simple``'s 3 and 4), decay
    exponentials, spread normals, PMT draws; S2 electrons (the maps'
    extraction probability), trapping exponentials, diffusion normals,
    Poisson photons per electron (the se-gain map's yield), the radial and
    azimuthal diffusion normals, then per photon the channel, luminescence
    and singlet uniforms, the singlet/triplet exponential, the spline's
    uniform (the time-spread normal's slot, JAX's key 14) and the PMT
    draws."""
    _pj, _kj, pt, kt, _conv = bundles
    inst = port_inst(jax_inst(4, 20000, 3))
    ph, tr, _ = s1.simulate_s1(pt, kt, inst, torch.Generator().manual_seed(5),
                               n_truth_rows=4)
    gen = torch.Generator().manual_seed(5)
    n_hits = s1.s1_n_photon_hits(
        pt, kt, torch.stack([inst['x'], inst['y'], inst['z']], 1),
        inst['amp'], gen)
    n = int(n_hits.sum())
    d = dict(n_hits=n_hits, u_ch=torch.rand(n, generator=gen),
             u_prop=torch.rand(n, generator=gen),
             exp=torch.empty(n).exponential_(1.0, generator=gen),
             normal=torch.randn(n, generator=gen), custom=None, u_nest=None,
             pmt=dict(tts=torch.randn(n, generator=gen),
                      dpe=torch.rand(n, generator=gen),
                      u1=torch.rand(n, generator=gen),
                      u2=torch.rand(n, generator=gen)))
    ph2, tr2, _ = s1.s1_photon_pass(pt, kt, inst, d, n_truth_rows=4)
    for a, b in ((ph, ph2), (tr, tr2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k

    inst = port_inst(jax_inst(4, 200, 4))
    ph, tr, _ = s2.simulate_s2(pt, kt, inst, torch.Generator().manual_seed(6),
                               n_truth_rows=4)
    gen = torch.Generator().manual_seed(6)
    d = s2.s2_draws(pt, kt, inst, gen)
    after = torch.rand(1, generator=gen)
    assert d['t_spread'] is None and d['aft_u0'] is None
    gen = torch.Generator().manual_seed(6)
    z_obs, pos = s2.s2_positions(pt, kt, inst)
    xy = torch.stack([inst['x'], inst['y']], 1)
    n_el = rs.binomial(gen, inst['amp'], s2.electron_yield_probability(
        pt, kt, inst['z'], xy, pos))
    assert torch.equal(n_el, d['n_electron'])
    E = int(n_el.sum())
    for k, fn in (('e_exp', lambda m: torch.empty(m).exponential_(
            1.0, generator=gen)), ('e_normal', lambda m: torch.randn(
                m, generator=gen))):
        assert torch.equal(fn(E), d[k]), k
    gain = pt.se_gain(pos) / torch.tensor(1 + kt.p_double_pe_emision)
    assert torch.equal(rs.poisson(gen, torch.repeat_interleave(gain, n_el)),
                       d['n_ph_per_e'])
    n = int(d['n_ph_per_e'].sum())
    for k, m, fn in (('diff_r', E, torch.randn), ('diff_a', E, torch.randn),
                     ('u_ch', n, torch.rand), ('u_lum', n, torch.rand),
                     ('u_st', n, torch.rand)):
        assert torch.equal(fn(m, generator=gen), d[k]), k
    assert torch.equal(torch.empty(n).exponential_(1.0, generator=gen),
                       d['exp_st'])
    assert torch.equal(torch.rand(n, generator=gen), d['u_prop'])
    for k, fn in (('tts', torch.randn), ('dpe', torch.rand),
                  ('u1', torch.rand), ('u2', torch.rand)):
        assert torch.equal(fn(n, generator=gen), d['pmt'][k]), k
    assert torch.equal(torch.rand(1, generator=gen), after)
    ph2, tr2, _ = s2.s2_photon_pass(pt, kt, inst, d, n_truth_rows=4)
    for a, b in ((ph, ph2), (tr, tr2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# every switch runs through the entry points


def _switch(name, maps):
    """The overrides of one switch alone (its map files read from
    ``maps``), or of the whole configuration."""
    files = dict(url_base=str(maps))
    efd = lambda **kw: dict(enable_field_dependencies=kw, **files,  # noqa
                            field_dependencies_map=FIELD_MAP_FILES[
                                'field_dependencies_map'],
                            diffusion_longitudinal_map=FIELD_MAP_FILES[
                                'diffusion_longitudinal_map'])
    s1_spline = dict(files, s1_time_spline=FIELD_MAP_FILES['s1_time_spline'])
    return {
        'comsol': dict(files, field_distortion_model='comsol',
                       field_distortion_comsol_map=FIELD_MAP_FILES[
                           'field_distortion_comsol_map']),
        'gas_gap_warping': dict(files, enable_gas_gap_warping=True,
                                gas_gap_map=FIELD_MAP_FILES['gas_gap_map']),
        's1_optical': dict(s1_spline, s1_model_type='optical_propagation'),
        's1_optical+simple': dict(s1_spline,
                                  s1_model_type='optical_propagation+simple'),
        's1_optical+custom': dict(s1_spline,
                                  s1_model_type='optical_propagation+custom'),
        's1_optical+nest': dict(s1_spline,
                                s1_model_type='optical_propagation+nest'),
        's2_optical': dict(files, s2_time_model='optical_propagation',
                           s2_time_spline=FIELD_MAP_FILES['s2_time_spline']),
        'drift_speed_map': efd(drift_speed_map=True),
        'drift_speed_map+norm': efd(drift_speed_map=True,
                                    norm_drift_velocity=True),
        'survival_probability_map': efd(survival_probability_map=True),
        'diffusion_longitudinal_map': efd(diffusion_longitudinal_map=True),
        'diffusion_transverse_map': efd(diffusion_transverse_map=True),
        'se_gain_from_map': dict(files, se_gain_from_map=True,
                                 se_gain_map=FIELD_MAP_FILES['se_gain_map']),
        'ext_eff_from_map': dict(ext_eff_from_map=True, g2_mean=16.5),
        'field_maps': field_maps_overrides(maps),
    }[name]


SWITCHES = ('comsol', 'gas_gap_warping', 's1_optical', 's1_optical+simple',
            's1_optical+custom', 's1_optical+nest', 's2_optical',
            'drift_speed_map', 'drift_speed_map+norm',
            'survival_probability_map', 'diffusion_longitudinal_map',
            'diffusion_transverse_map', 'se_gain_from_map',
            'ext_eff_from_map', 'field_maps')


@pytest.mark.parametrize('name', SWITCHES)
def test_switch_runs(maps_dir, name):
    """``Resource``, ``build_params`` and ``Simulator(cfg,
    device='cpu').get_arrays`` run with the switch on (before this slice
    each raised NotImplementedError): the truth has a row an
    instruction, the records are strax-ordered, and the switch took
    effect in the parameters or constants."""
    over = _switch(name, maps_dir)
    cfg = default_config(seed=7, chunk_size=100, **over)
    res = Resource(cfg)
    params = build_params(cfg, res, 'cpu')
    const = build_constants(cfg)
    s1.s1_models(const.s1_model_type)
    s2.check_supported(const)
    took = {'comsol': params.fd_comsol, 'gas_gap_warping': params.gas_gap_map,
            's2_optical': params.s2_prop_top,
            'se_gain_from_map': params.se_gain}.get(name, True)
    if name.startswith('s1_optical'):
        took = params.s1_prop_top
    elif name in ('drift_speed_map', 'survival_probability_map',
                  'diffusion_transverse_map'):
        took = res.field_dependencies_map
    elif name == 'diffusion_longitudinal_map':
        took = params.diffusion_long_map
    assert took is not None
    inst = bench_instructions(3, 2000, 300)
    out = Simulator(cfg, device='cpu').get_arrays(inst)
    rr, truth = out['raw_records'], out['truth']
    assert len(truth) == len(inst) and len(rr) > 100
    assert (np.diff(rr['time']) >= 0).all() and (rr['length'] <= 110).all()
    s2_rows = truth[truth['type'] == 2]
    assert (s2_rows['n_electron'] > 0).all()
    if name in ('comsol', 'field_maps'):
        r_shift = (np.hypot(s2_rows['x'], s2_rows['y'])
                   - np.hypot(s2_rows['x_mean_electron'],
                              s2_rows['y_mean_electron']))
        assert np.all(r_shift > 0) and np.all(r_shift < 5)
