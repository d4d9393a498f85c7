"""Physics stages of wfsim_tpu_torch against wfsim_tpu and numpy oracles.

Given-draw parity: the same normals and uniforms (drawn with jax.random
exactly as the JAX functions draw them, or with numpy) go to both
packages.  Tolerances, per quantity:

- channels, DPE flags, validity, categorical and search indices: exact;
- times after ``trunc_int``: exact, except photons whose float32 time lands
  within rounding of an integer (the two packages sum and interpolate in
  another order); such photons differ by exactly 1 ns and are counted,
  at most 1 in 10^3;
- gains: rtol 1e-6; truth sums (float32 in JAX, float64 here): rtol 1e-5;
- map lookups: rtol 1e-6;
- distributions: two-sample KS against numpy oracles of the reference's
  sampling procedure, p > 1e-3.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy.stats import ks_2samp

from wfsim_tpu import units
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.models.pmt import pmt_response as jax_pmt_response
from wfsim_tpu.models.s2 import luminescence_simple as jax_luminescence
from wfsim_tpu.ops.interp import grid_lookup as jax_grid_lookup
from wfsim_tpu.ops.randsample import (categorical_from_cdf as jax_categorical,
                                      search_sorted_rows as jax_search)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.models.pmt import pmt_response, photon_time_stats
from wfsim_tpu_torch.models.s1 import simulate_s1
from wfsim_tpu_torch.models.s2 import (luminescence_simple, luminescence_tables,
                                       simulate_s2, Q)
from wfsim_tpu_torch.ops.interp import grid_lookup
from wfsim_tpu_torch.ops.randsample import (categorical_from_cdf,
                                            search_sorted_rows)
from wfsim_tpu_torch.ops.segment import edges_from_counts
from wfsim_tpu_torch.resources import load_config

P_MIN = 1e-3


@pytest.fixture(scope='module')
def both():
    cj = jax_default_config()
    c = default_config()
    return ((jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


def t32(a):
    return torch.from_numpy(np.array(a))


def trunc_mismatch(a, b, n_max_frac=1e-3):
    """Times equal except a few 1-ns rounding flips; returns the count."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    bad = a != b
    assert np.all(np.abs(a - b)[bad] == 1)
    assert bad.sum() <= max(1, n_max_frac * len(a)), bad.sum()
    return int(bad.sum())


def test_pmt_response_given_draws(both):
    (pj, kj), (c, pt, kt) = both
    rng = np.random.default_rng(0)
    n, rows = 20000, 12
    counts = rng.multinomial(n, np.ones(rows) / rows)
    truth_row = np.repeat(np.arange(rows), counts)
    t = rng.integers(0, 100000, n).astype(np.int32)
    ch = rng.integers(-1, 494, n).astype(np.int32)
    valid = ch >= 0
    key = jax.random.split(jax.random.key(7), 4)
    draws = dict(tts=jax.random.normal(key[0], (n,)),
                 dpe=jax.random.uniform(key[1], (n,)),
                 u1=jax.random.uniform(key[2], (n,)),
                 u2=jax.random.uniform(key[3], (n,)))
    edges = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    phj, trj = jax_pmt_response(pj, kj, jnp.asarray(t), jnp.asarray(ch),
                                jnp.asarray(valid), jnp.asarray(truth_row),
                                key, n_truth_rows=rows,
                                row_edges=jnp.asarray(edges))
    pht, trt = pmt_response(pt, kt, t32(t), t32(ch), t32(valid),
                            t32(truth_row), {k: t32(v) for k, v in draws.items()},
                            n_truth_rows=rows, row_edges=t32(edges).long())
    trunc_mismatch(phj['t'], pht['t'])
    for k in ('ch', 'is_dpe', 'valid'):
        np.testing.assert_array_equal(np.asarray(phj[k]), pht[k].numpy(), k)
    np.testing.assert_allclose(np.asarray(phj['gain']), pht['gain'].numpy(),
                               rtol=1e-6)
    for k, v in trj.items():
        np.testing.assert_allclose(np.asarray(v), trt[k].numpy(), rtol=1e-5,
                                   err_msg=k)


def test_luminescence_given_draws(both):
    (pj, kj), (c, pt, kt) = both
    rng = np.random.default_rng(1)
    n_inst, n = 6, 30000
    xy = rng.uniform(-40, 40, (n_inst, 2)).astype(np.float32)
    ph_inst = np.sort(rng.integers(0, n_inst, n)).astype(np.int32)
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, (n,)))
    tj = np.asarray(jax_luminescence(pj, kj, key, jnp.asarray(xy),
                                     jnp.asarray(ph_inst),
                                     jnp.ones(n, bool)))
    inv = luminescence_tables(kt, n_inst, 'cpu')
    tt = luminescence_simple(inv, t32(ph_inst), t32(u)).numpy()
    # u*(Q-1) rounding up to Q-1 reads the next row's table in wfsim_tpu
    ok = np.float32(u) * np.float32(Q - 1) < np.float32(Q - 1)
    assert ok.sum() > 0.999 * n
    trunc_mismatch(tj[ok], tt[ok])


def test_categorical_shared_cdf(both):
    rng = np.random.default_rng(2)
    R, C, n = 9, 494, 50000
    pat = rng.random((R, C)).astype(np.float32) * (rng.random((R, C)) > 0.3)
    pat[4] = 0.0                                      # a row with zero mass
    pat[:, 17] = 0.0                                  # a channel never drawn
    cdf = np.cumsum(pat, axis=1).astype(np.float32)
    row = rng.integers(0, R, n).astype(np.int32)
    u = rng.random(n).astype(np.float32)
    u[:5] = 0.0
    a = np.asarray(jax_categorical(jnp.asarray(cdf), jnp.asarray(row),
                                   jnp.asarray(u)))
    b = categorical_from_cdf(t32(cdf), t32(row), t32(u)).numpy()
    np.testing.assert_array_equal(a, b)
    assert np.all(b[row == 4] == -1) and not np.any(b == 17)


@pytest.mark.parametrize('side', ['left', 'right'])
@pytest.mark.parametrize('kind', ['float', 'int'])
def test_search_sorted_rows(side, kind):
    rng = np.random.default_rng(4)
    R, C, n = 7, 300, 20000
    if kind == 'float':
        tab = np.sort(rng.normal(0, 3, (R, C)).astype(np.float32), axis=1)
        tab[:, 100:110] = tab[:, 100:101]             # runs of equal values
        q = np.concatenate([rng.normal(0, 4, n - 50), tab[0, 95:145],
                            ]).astype(np.float32)
    else:
        tab = np.sort(rng.integers(-50, 50, (R, C)), axis=1).astype(np.int32)
        q = rng.integers(-60, 60, n).astype(np.int32)
    row = rng.integers(0, R, n).astype(np.int32)
    a = np.asarray(jax_search(jnp.asarray(tab), jnp.asarray(row),
                              jnp.asarray(q), side=side))
    b = search_sorted_rows(t32(tab), t32(row), t32(q), side=side).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('shape', [(5, 1), (3, 4, 7), (2, 2, 2, 494)])
def test_grid_lookup_matches_jax(shape):
    rng = np.random.default_rng(5)
    vals = rng.random(shape).astype(np.float32)
    d = len(shape) - 1
    lows = rng.uniform(-50, 0, d).astype(np.float32)
    highs = lows + rng.uniform(1, 60, d).astype(np.float32)
    pts = rng.uniform(-70, 70, (500, d)).astype(np.float32)
    a = np.asarray(jax_grid_lookup(jnp.asarray(vals), jnp.asarray(lows),
                                   jnp.asarray(highs), jnp.asarray(pts)))
    b = grid_lookup(t32(vals), t32(lows), t32(highs), t32(pts)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_time_stats_exact_for_late_rows():
    """Per-row moments stay exact far into a large batch (ROADMAP Queue 3
    F1): against numpy float64, rtol 1e-12."""
    rng = np.random.default_rng(6)
    counts = np.array([3, 200_000, 1, 150_000])
    t = np.concatenate([rng.integers(0, 2_000_000_000 // (k + 1), n)
                        + 10_000_000 * k for k, n in enumerate(counts)])
    t = t.astype(np.int32)
    row = np.repeat(np.arange(4), counts)
    st = photon_time_stats(t32(t), torch.ones(len(t), dtype=torch.bool),
                           t32(row).long(), 4, edges_from_counts(t32(counts)))
    for r in range(4):
        x = t[row == r].astype(np.float64)
        assert int(st['count'][r]) == len(x)
        assert int(st['t_min'][r]) == x.min() and int(st['t_max'][r]) == x.max()
        np.testing.assert_allclose(float(st['t_mean_offset'][r]),
                                   x.mean() - x.min(), rtol=1e-12)
        np.testing.assert_allclose(float(st['t_sigma'][r]), x.std(),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# distributions (numpy oracles of the reference sampling procedures)


def ks_ok(a, b):
    res = ks_2samp(np.asarray(a, float), np.asarray(b, float))
    assert res.pvalue > P_MIN, (res.statistic, res.pvalue)


def inst_batch(n, amp, z=-50.0):
    return dict(time=torch.zeros(n, dtype=torch.int32),
                x=torch.full((n,), 10.0), y=torch.full((n,), -5.0),
                z=torch.full((n,), z), amp=torch.full((n,), amp,
                                                      dtype=torch.int32),
                truth_row=torch.arange(n))


def test_ks_s1_counts_and_times(both):
    c, pt, kt = both[1]
    gen = torch.Generator().manual_seed(11)
    n = 3000
    ph, truth, req = simulate_s1(pt, kt, inst_batch(n, 2000), gen,
                                 n_truth_rows=n)
    ly = 494 * 14e-5 / (1 + c['p_double_pe_emision']) \
        * c['s1_detection_efficiency']
    rng = np.random.default_rng(12)
    ks_ok(req.numpy(), rng.binomial(2000, ly, n))
    np.testing.assert_array_equal(truth['photon_count'].numpy(), req.numpy())
    t = ph['t'].numpy()
    m = len(t)
    oracle = (np.trunc(rng.exponential(c['s1_decay_time'], m))
              + np.trunc(rng.normal(0, c['s1_decay_spread'], m))
              + np.trunc(rng.normal(c['pmt_transit_time_mean'],
                                    c['pmt_transit_time_spread'] / 2.35482, m)))
    ks_ok(t, oracle)


def test_ks_s2_counts(both):
    c, pt, kt = both[1]
    gen = torch.Generator().manual_seed(13)
    n, z = 1500, -60.0
    ph, truth, req = simulate_s2(pt, kt, inst_batch(n, 300, z), gen,
                                 n_truth_rows=n)
    drift = -z / c['drift_velocity_liquid'] + c['drift_time_gate']
    p_e = np.exp(-drift / c['electron_lifetime_liquid'])
    gain = c['s2_secondary_sc_gain'] / (1 + c['p_double_pe_emision'])
    rng = np.random.default_rng(14)
    ne = rng.binomial(300, p_e, n)
    ks_ok(truth['n_electron'].numpy(), ne)
    ks_ok(req.numpy(), rng.poisson(rng.binomial(300, p_e, n) * gain))


def test_ks_luminescence_simple(both):
    """Against the float64 anode-field integration of the reference
    (s2.py:317-378), as tests/test_reference_distributions.py draws it."""
    c, pt, kt = both[1]
    n = 40000
    inv = luminescence_tables(kt, 1, 'cpu')
    u = torch.rand(n, generator=torch.Generator().manual_seed(15))
    ours = luminescence_simple(inv, torch.zeros(n, dtype=torch.int64), u)
    number_density_gas = c['pressure'] / (units.boltzmannConstant
                                          * c['temperature'])
    alpha = c['gas_drift_velocity_slope'] / number_density_gas
    dG = c['elr_gas_gap_length']
    rA, rW = c['anode_field_domination_distance'], c['anode_wire_radius']
    dL = c['gate_to_anode_distance'] - dG
    VG = c['anode_voltage'] / (1 + dL / dG / c['lxe_dielectric_constant'])
    E0 = VG / ((dG - rA) / rA + np.log(rA / rW))
    r = np.arange(dG, rW, -1e-4)
    rr = np.clip(1 / r, 1 / rA, 1 / rW)
    dt = 1e-4 / (alpha * E0 * rr)
    dy = E0 * rr / (units.kV / units.cm) - 0.8 * c['pressure'] / units.bar
    t = np.cumsum(dt) - np.sum(np.cumsum(dt) * dy) / np.sum(dy)
    y = np.cumsum(dy)
    rng = np.random.default_rng(16)
    ks_ok(ours.numpy(), np.interp(rng.random(n), y / y[-1], t).astype(np.int64))
