"""The physics photon passes of wfsim_tpu_torch (S1, S2 and the PMT
response) split into draws and a pure pass, against wfsim_tpu given the
same draws and against numpy oracles.

Tolerances, per quantity:

- channels, DPE flags, validity, photon counts, integer-valued truth sums
  (counts, PE, triggers), electron counts: exact; against JAX, channels are
  exact except photons whose target lies between wfsim_tpu's float32 CDF
  entry and the port's float64-accumulated one (counted, at most 1 in
  10^3; none at these seeds);
- times against JAX: ``trunc_mismatch`` (at most 1 in 10^3 photons off by
  exactly 1 ns: the packages round in another order);
- gains against JAX: rtol 1e-6; JAX's float32 truth sums: rtol 1e-5;
  its min/max times: within 1 ns;
- the luminescence tables and the channel draw against their numpy
  oracles (float64 accumulation in sequence, each value rounded to float32
  once, float32 arithmetic in the twin's order): bitwise;
- the truth row sums against numpy per-row float64 sums: counts exact,
  areas and moments rtol 1e-12.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from wfsim_tpu import units
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.models import s1 as js1, s2 as js2
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import (build_params, build_constants,
                                           params_from_numpy)
from wfsim_tpu_torch.models import pmt, s1, s2
from wfsim_tpu_torch.ops import randsample as rs
from wfsim_tpu_torch.resources import load_config

from .test_torch_host import export_jax_params
from .test_torch_physics import trunc_mismatch


@pytest.fixture(scope='module')
def both():
    cj = jax_default_config()
    c = default_config()
    return ((jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


def t32(a):
    return torch.from_numpy(np.array(a))


def jax_inst(n, amp, seed):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 60 ** 2, n))
    phi = rng.uniform(-np.pi, np.pi, n)
    return dict(time=(np.arange(n) * 40_000).astype(np.int32),
                x=(r * np.cos(phi)).astype(np.float32),
                y=(r * np.sin(phi)).astype(np.float32),
                z=rng.uniform(-140, -5, n).astype(np.float32),
                amp=np.full(n, amp, np.int32), recoil=np.full(n, 7, np.int32),
                valid=np.ones(n, bool), truth_row=np.arange(n, dtype=np.int32))


def port_inst(ji):
    return dict(time=t32(ji['time']), x=t32(ji['x']), y=t32(ji['y']),
                z=t32(ji['z']), amp=t32(ji['amp']),
                truth_row=t32(ji['truth_row']).long())


def channels_agree(ch_j, ch_t, cdf_j, cdf_t, ph_inst, u):
    """Channels equal except where the target lies between the two
    packages' CDF entries (returns that count)."""
    tot_j, tot_t = cdf_j[ph_inst, -1], cdf_t[ph_inst, -1]
    amb = np.array([np.searchsorted(cdf_j[i], uu * a, side='right')
                    != np.searchsorted(cdf_t[i], uu * b, side='right')
                    for i, uu, a, b in zip(ph_inst, u, tot_j, tot_t)], bool)
    np.testing.assert_array_equal(ch_j[~amb], ch_t[~amb])
    assert amb.sum() <= max(1, 1e-3 * len(u)), amb.sum()
    return int(amb.sum())


def compare_truth(trj, trt, n):
    for k in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger',
              'photon_count'):
        np.testing.assert_allclose(np.asarray(trj[k])[:n], trt[k].numpy(),
                                   rtol=1e-5, err_msg=k)
    for k in ('raw_area', 'raw_area_trigger', 'raw_area_bottom'):
        np.testing.assert_allclose(np.asarray(trj[k])[:n], trt[k].numpy(),
                                   rtol=1e-5, err_msg=k)
    for k in ('photon_t_min', 'photon_t_max'):
        np.testing.assert_allclose(np.asarray(trj[k])[:n], trt[k].numpy(),
                                   atol=1, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# draws then pass: one seed, one stream


def test_s1_draw_order(both):
    """simulate_s1 equals the pass over draws made in this order:
    binomial counts, channel uniforms, decay exponentials, spread normals,
    then the PMT normal and three uniforms."""
    c, pt, kt = both[1]
    inst = port_inst(jax_inst(5, 20000, 1))
    ph, tr, req = s1.simulate_s1(pt, kt, inst, torch.Generator().manual_seed(3),
                                 n_truth_rows=5)
    gen = torch.Generator().manual_seed(3)
    n_hits = s1.s1_n_photon_hits(
        pt, kt, torch.stack([inst['x'], inst['y'], inst['z']], 1),
        inst['amp'], gen)
    n = int(n_hits.sum())
    draws = dict(n_hits=n_hits, u_ch=torch.rand(n, generator=gen),
                 exp=torch.empty(n).exponential_(1.0, generator=gen),
                 normal=torch.randn(n, generator=gen),
                 pmt=dict(tts=torch.randn(n, generator=gen),
                          dpe=torch.rand(n, generator=gen),
                          u1=torch.rand(n, generator=gen),
                          u2=torch.rand(n, generator=gen)))
    ph2, tr2, req2 = s1.s1_photon_pass(pt, kt, inst, draws, n_truth_rows=5)
    for a, b in ((ph, ph2), (tr, tr2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(req, req2) and n > 500


def test_s2_draw_order(both):
    """simulate_s2 equals the pass over draws made in this order: binomial
    electrons, trapping exponentials, diffusion normals, Poisson photons
    per electron, then per photon the channel, luminescence and singlet
    uniforms, the singlet/triplet exponential, the time-spread normal and
    the PMT draws."""
    c, pt, kt = both[1]
    inst = port_inst(jax_inst(4, 200, 2))
    ph, tr, req = s2.simulate_s2(pt, kt, inst, torch.Generator().manual_seed(4),
                                 n_truth_rows=4)
    gen = torch.Generator().manual_seed(4)
    mean, _ = s2.get_s2_drift_time_params(kt, inst['z'])
    cy = torch.exp(-mean / torch.tensor(kt.electron_lifetime_liquid)) \
        * kt.electron_extraction_yield
    n_el = rs.binomial(gen, inst['amp'], cy)
    gain = pt.s2_correction(torch.stack([inst['x'], inst['y']], 1)) \
        * kt.s2_secondary_sc_gain / torch.tensor(1 + kt.p_double_pe_emision)
    E = int(n_el.sum())
    d = dict(n_electron=n_el,
             e_exp=torch.empty(E).exponential_(1.0, generator=gen),
             e_normal=torch.randn(E, generator=gen))
    d['n_ph_per_e'] = rs.poisson(gen, torch.repeat_interleave(gain, n_el))
    n = int(d['n_ph_per_e'].sum())
    d.update(u_ch=torch.rand(n, generator=gen),
             u_lum=torch.rand(n, generator=gen),
             u_st=torch.rand(n, generator=gen),
             exp_st=torch.empty(n).exponential_(1.0, generator=gen),
             t_spread=torch.randn(n, generator=gen),
             pmt=dict(tts=torch.randn(n, generator=gen),
                      dpe=torch.rand(n, generator=gen),
                      u1=torch.rand(n, generator=gen),
                      u2=torch.rand(n, generator=gen)))
    ph2, tr2, req2 = s2.s2_photon_pass(pt, kt, inst, d, n_truth_rows=4)
    for a, b in ((ph, ph2), (tr, tr2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(req, req2) and n > 5000


# ---------------------------------------------------------------------------
# given-draw parity of the pure passes with wfsim_tpu


def _jax_pmt_draws(keys, n):
    return dict(tts=jax.random.normal(keys[0], (n,)),
                dpe=jax.random.uniform(keys[1], (n,)),
                u1=jax.random.uniform(keys[2], (n,)),
                u2=jax.random.uniform(keys[3], (n,)))


def _np(d):
    return {k: (_np(v) if isinstance(v, dict) else t32(v))
            for k, v in d.items()}


def test_s1_pass_matches_jax_given_draws(both):
    (pj, kj), (c, pt, kt) = both
    ji = jax_inst(6, 150_000, 5)
    jinst = {k: jnp.asarray(v) for k, v in ji.items()}
    key = jax.random.key(11)
    keys = jax.random.split(key, js1.N_S1_KEYS)
    pos = jnp.stack([jinst['x'], jinst['y'], jinst['z']], axis=1)
    n_hits = js1.s1_n_photon_hits(pj, kj, pos, jinst['amp'], jinst['valid'],
                                  keys[0])
    n = int(n_hits.sum())
    phj, trj, _ = js1.simulate_s1(pj, kj, jinst, key, capacity=n,
                                  n_truth_rows=6)
    draws = _np(dict(n_hits=n_hits,
                     u_ch=jax.random.uniform(keys[1], (n,)),
                     exp=jax.random.exponential(keys[3], (n,)),
                     normal=jax.random.normal(keys[4], (n,)),
                     pmt=_jax_pmt_draws(keys[17:21], n)))
    pht, trt, req = s1.s1_photon_pass(pt, kt, port_inst(ji), draws,
                                      n_truth_rows=6)
    assert n > 5000 and int(req.sum()) == n
    pattern = s1.masked_pattern(pt, pt.s1_pattern,
                                torch.stack([t32(ji['x']), t32(ji['y']),
                                             t32(ji['z'])], 1)).numpy()
    ph_inst = np.repeat(np.arange(6), np.asarray(n_hits))
    channels_agree(np.asarray(phj['ch']), pht['ch'].numpy(),
                   np.asarray(jnp.cumsum(jnp.asarray(pattern), axis=1)),
                   rs.cumsum_f64(t32(pattern), 1).numpy(), ph_inst,
                   draws['u_ch'].numpy())
    trunc_mismatch(phj['t'], pht['t'])
    for k in ('is_dpe', 'valid'):
        np.testing.assert_array_equal(np.asarray(phj[k]), pht[k].numpy(), k)
    np.testing.assert_allclose(np.asarray(phj['gain']), pht['gain'].numpy(),
                               rtol=1e-6)
    compare_truth(trj, trt, 6)


def test_s2_pass_matches_jax_given_draws(both):
    (pj, kj), (c, pt, kt) = both
    ji = jax_inst(5, 300, 6)
    jinst = {k: jnp.asarray(v) for k, v in ji.items()}
    key = jax.random.key(12)
    keys = jax.random.split(key, js2.N_S2_KEYS)
    st = js2._s2_electron_stage(pj, kj, jinst, keys, e_capacity=4096)
    E = int(st['total_e'])
    st = js2._s2_electron_stage(pj, kj, jinst, keys, e_capacity=E)
    n = int(st['n_ph_per_e'].sum())
    phj, trj, _ = js2.simulate_s2(pj, kj, jinst, key, e_capacity=E,
                                  capacity=n, n_truth_rows=5)
    draws = _np(dict(
        n_electron=st['n_electron'], e_exp=jax.random.exponential(keys[1], (E,)),
        e_normal=jax.random.normal(keys[2], (E,)),
        n_ph_per_e=st['n_ph_per_e'], u_ch=jax.random.uniform(keys[5], (n,)),
        u_lum=jax.random.uniform(keys[10], (n,)),
        u_st=jax.random.uniform(keys[12], (n,)),
        exp_st=jax.random.exponential(keys[13], (n,)),
        t_spread=jax.random.normal(keys[14], (n,)),
        pmt=_jax_pmt_draws(keys[15:19], n)))
    pht, trt, req = s2.s2_photon_pass(pt, kt, port_inst(ji), draws,
                                      n_truth_rows=5)
    assert n > 10000 and int(req.sum()) == n
    # u * (Q-1) rounding up to Q-1 reads the next row in wfsim_tpu (F2)
    assert np.all(draws['u_lum'].numpy() * np.float32(s2.Q - 1)
                  < np.float32(s2.Q - 1))
    np.testing.assert_array_equal(np.asarray(trj['n_electron']),
                                  trt['n_electron'].numpy())
    pattern = s1.masked_pattern(pt, pt.s2_pattern,
                                torch.stack([t32(ji['x']), t32(ji['y'])],
                                            1)).numpy()
    ph_inst = np.repeat(np.repeat(np.arange(5), np.asarray(st['n_electron'])),
                        np.asarray(st['n_ph_per_e']))
    channels_agree(np.asarray(phj['ch']), pht['ch'].numpy(),
                   np.asarray(jnp.cumsum(jnp.asarray(pattern), axis=1)),
                   rs.cumsum_f64(t32(pattern), 1).numpy(), ph_inst,
                   draws['u_ch'].numpy())
    trunc_mismatch(phj['t'], pht['t'])
    for k in ('is_dpe', 'valid'):
        np.testing.assert_array_equal(np.asarray(phj[k]), pht[k].numpy(), k)
    np.testing.assert_allclose(np.asarray(phj['gain']), pht['gain'].numpy(),
                               rtol=1e-6)
    compare_truth(trj, trt, 5)
    for k in ('electron_count', 'electron_t_min', 'electron_t_max'):
        np.testing.assert_allclose(np.asarray(trj[k]), trt[k].numpy(),
                                   atol=1, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# F10: the twins' reductions against numpy oracles, bitwise


def tables_oracle(const, n_inst, qs):
    """The luminescence tables in numpy: the twin's float32 steps, float64
    accumulation in sequence, each value rounded to float32 once."""
    f = np.float32
    number_density_gas = const.pressure / (units.boltzmannConstant
                                           * const.temperature)
    alpha = const.gas_drift_velocity_slope / number_density_gas
    rA, rW = const.anode_field_domination_distance, const.anode_wire_radius
    dG = np.full(n_inst, f(const.elr_gas_gap_length))
    dL = f(const.gate_to_anode_distance) - dG
    VG = f(1) / (f(1) + dL / dG / f(const.lxe_dielectric_constant)) \
        * f(const.anode_voltage)
    E0 = VG / ((dG - f(rA)) / f(rA) + f(np.log(rA / rW)))
    r = np.arange(const.gate_to_anode_distance, rW, -1e-4, dtype=np.float32)
    rr = np.clip(f(1) / r, f(1 / rA), f(1 / rW))
    dt = f(1) / (f(alpha) * E0[:, None] * rr[None, :]) * f(1e-4)
    dy = E0[:, None] * rr[None, :] / f(units.kV / units.cm) \
        - f(0.8 * (const.pressure / units.bar))
    mask = r[None, :] <= dG[:, None]
    dt, dy = np.where(mask, dt, f(0)), np.where(mask, dy, f(0))
    t64 = np.zeros(dt.shape)
    y64 = np.zeros(dt.shape)
    num = np.zeros(n_inst)
    at, ay = np.zeros(n_inst), np.zeros(n_inst)
    for k in range(dt.shape[1]):          # one float64 add at a time
        at = at + dt[:, k].astype(np.float64)
        ay = ay + dy[:, k].astype(np.float64)
        t64[:, k], y64[:, k] = at, ay
        num = num + (t64[:, k].astype(f) * dy[:, k]).astype(np.float64)
    t_cum, y_cum = t64.astype(f), y64.astype(f)
    avgt = (num / np.maximum(ay, 1e-30)).astype(f)
    t_cum = t_cum - avgt[:, None]
    out = np.zeros((n_inst, len(qs)), f)
    R = dt.shape[1]
    for i in range(n_inst):
        uq = qs * y_cum[i, -1]
        i1 = np.clip(np.searchsorted(y_cum[i], uq, side='left'), 1, R - 1)
        x0, x1 = y_cum[i, i1 - 1], y_cum[i, i1]
        y0, y1 = t_cum[i, i1 - 1], t_cum[i, i1]
        with np.errstate(divide='ignore', invalid='ignore'):
            w = np.where(x1 > x0, (uq - x0) / np.maximum(x1 - x0, f(1e-30)),
                         f(0))
        w = np.clip(w, f(0), f(1))
        out[i] = y0 * (f(1) - w) + y1 * w
    return out


def test_luminescence_tables_match_float64_oracle(both):
    c, pt, kt = both[1]
    qs = s2._radius_grid(kt, torch.device('cpu'))[2].numpy()
    tab = s2.luminescence_tables(kt, 3, 'cpu').numpy()
    np.testing.assert_array_equal(tab.view(np.int32),
                                  tables_oracle(kt, 3, qs).view(np.int32))


def test_channel_draw_matches_float64_oracle():
    rng = np.random.default_rng(7)
    I, C = 7, 494
    pat = (rng.random((I, C)) * (rng.random((I, C)) > 0.25)).astype(
        np.float32) * np.float32(1e-3)
    pat[2] = 0.0
    counts = rng.integers(0, 4000, I)
    edges = np.concatenate([[0], np.cumsum(counts)])
    u = rng.random(int(edges[-1])).astype(np.float32)
    u[:3] = 0.0
    ch = rs.channel_draw(t32(pat), t32(edges), t32(u)).numpy()
    cdf = np.zeros((I, C), np.float32)
    for i in range(I):
        acc = 0.0
        for k in range(C):
            acc += float(pat[i, k])
            cdf[i, k] = np.float32(acc)
    row = np.repeat(np.arange(I), counts)
    tot = cdf[row, -1]
    expect = np.array([min(np.searchsorted(cdf[i], np.float32(uu * tt),
                                           side='right'), C - 1)
                       for i, uu, tt in zip(row, u, tot)])
    np.testing.assert_array_equal(ch, np.where(tot > 0, expect, -1))
    np.testing.assert_array_equal(
        rs.cumsum_f64(t32(pat), 1).numpy().view(np.int32), cdf.view(np.int32))


# ---------------------------------------------------------------------------
# K8: the truth rows against numpy per-row sums


@pytest.mark.parametrize('late', [False, True])
def test_truth_rows_match_numpy(both, late):
    """Per-row truth sums and time statistics of pmt_response against
    float64 numpy; ``late`` spreads the times to 2e9 ns with rows of
    200,000 photons (ROADMAP F1)."""
    c, pt, kt = both[1]
    rng = np.random.default_rng(8 + late)
    counts = (np.array([3, 200_000, 0, 1, 150_000]) if late
              else rng.integers(0, 3000, 9))
    rows = len(counts)
    n = int(counts.sum())
    row = np.repeat(np.arange(rows), counts)
    t = (rng.integers(0, 2_000_000_000 // (row + 1), n) if late
         else rng.integers(-200, 400_000, n)).astype(np.int32)
    ch = rng.integers(-1, 494, n).astype(np.int32)
    gen = torch.Generator().manual_seed(9)
    edges = t32(np.concatenate([[0], np.cumsum(counts)]))
    ph, tr = pmt.pmt_response(pt, kt, t32(t), t32(ch), t32(ch >= 0),
                              t32(row), pmt.pmt_draws(gen, n, 'cpu'),
                              n_truth_rows=rows, row_edges=edges)
    v = ph['valid'].numpy()
    chc = np.clip(ph['ch'].numpy(), 0, 493)
    cp = pt.chan_pack.numpy()[chc]
    gain, tt = ph['gain'].numpy(), ph['t'].numpy()
    cm = pt.current_max.numpy()[np.mod(tt, kt.sample_duration)]
    above = v & (gain * cm * np.float32(kt.current_2_adc) > cp[:, 1])
    dpe = ph['is_dpe'].numpy() & v
    area = np.where(v, gain / np.maximum(cp[:, 0], np.float32(1e-30)), 0)
    w = dict(n_photon=v * 1.0, n_pe=v + dpe * 1.0, n_photon_trigger=above * 1.0,
             n_pe_trigger=above + (above & dpe) * 1.0, raw_area=area,
             raw_area_trigger=np.where(above, area, 0))
    bot = (cp[:, 3] > 0) & v
    for r in range(rows):
        m = row == r
        for name, x in w.items():
            for suffix, mask in (('', v), ('_bottom', bot)):
                got = float(tr[name + suffix][r])
                want = float(np.sum(x[m & mask].astype(np.float64)))
                if name.startswith('raw_area'):
                    np.testing.assert_allclose(got, want, rtol=1e-12,
                                               atol=1e-300)
                else:
                    assert got == want, (name + suffix, r)
        x = tt[m & v].astype(np.float64)
        assert int(tr['photon_count'][r]) == len(x)
        if not len(x):
            assert int(tr['photon_t_min'][r]) == 2 ** 31 - 1
            assert int(tr['photon_t_max'][r]) == -(2 ** 31 - 1)
            continue
        assert int(tr['photon_t_min'][r]) == x.min()
        assert int(tr['photon_t_max'][r]) == x.max()
        np.testing.assert_allclose(float(tr['photon_t_mean_offset'][r]),
                                   x.mean() - x.min(), rtol=1e-12)
        np.testing.assert_allclose(float(tr['photon_t_sigma'][r]), x.std(),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# parameters carried over from the JAX bundle


def test_jax_bundle_gives_the_same_passes(both):
    """params_from_numpy (wfsim_tpu's bundle as numpy) drives both passes
    to the same bits as build_params: every table and constant the kernels
    read is carried."""
    (pj, kj), (c, pt, kt) = both
    conv, kc = params_from_numpy(export_jax_params(pj),
                                 dataclasses.asdict(kj), 'cpu')
    assert torch.equal(s2.luminescence_tables(kc, 2, 'cpu'),
                       s2.luminescence_tables(kt, 2, 'cpu'))
    inst = port_inst(jax_inst(3, 300, 10))
    for draw, run in ((s1.s1_draws, s1.s1_photon_pass),
                      (s2.s2_draws, s2.s2_photon_pass)):
        d = draw(pt, kt, inst, torch.Generator().manual_seed(10))
        a = run(pt, kt, inst, d, n_truth_rows=3)
        b = run(conv, kc, inst, d, n_truth_rows=3)
        for x, y in zip(a[:2], b[:2]):
            for k in x:
                assert torch.equal(x[k], y[k]), k
        assert torch.equal(a[2], b[2])
