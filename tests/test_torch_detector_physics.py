"""The ``detector_physics`` configuration of wfsim_tpu_torch (NEST S1
timing, garfield gas-gap luminescence, transverse diffusion, AFT
smearing, inverse FDC, an S2 pattern map read from a file) against
wfsim_tpu on the CPU.

Tolerances, per quantity:

- given the same draws (JAX's regenerated from its keys): NEST delays
  bitwise and S1 photon times equal; the diffused S2 pattern within rtol
  1e-6 (wfsim_tpu sums the electrons' patterns in float32, the port in
  float64); channels equal except photons whose target lies within 1e-6
  (relative) of an edge of the port's CDF, where the two packages' CDFs
  may order the target differently (such photons are counted; none of
  them changes channel at these seeds); gas-gap times within 1
  ns, the 1-ns differences counted and at most 1e-4 of the photons (the
  instruction means are summed in float32 by wfsim_tpu and exactly by the
  port); S2 photon times within 1 ns, differences at most 1e-3; the
  field-distorted mean electron position within 1e-5 cm;
- with every new switch off, the default generator stream is unchanged:
  pinned integer sums of the S1 and S2 passes at a fixed seed (the values
  wfsim_tpu_torch gave before these switches existed).
"""
import dataclasses
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models import s1 as js1, s2 as js2
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import Simulator, ChunkRawRecords, RawData
from wfsim_tpu_torch.config import default_config, detector_physics_overrides
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.models import s1, s2
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.ops import randsample as rs
from wfsim_tpu_torch.ops.segment import edges_from_counts
from wfsim_tpu_torch.resources import load_config
from wfsim_tpu_torch.resources.nest_tables import build_nest_timing_tables
from wfsim_tpu_torch.resources.synthetic import write_pattern_map

from .test_torch_maps import jax_pattern_maps
from .test_torch_photon_passes import (jax_inst, port_inst, _np,
                                       _jax_pmt_draws, t32)
from .test_torch_physics import trunc_mismatch


@pytest.fixture(scope='module')
def pattern_file(tmp_path_factory):
    return write_pattern_map(tmp_path_factory.mktemp('dp') / 'pmap.json', 5)


def with_small_nest_tables(pj, kj, pt, kt):
    """Both bundles switched to NEST S1 timing with the port's tables of
    2,000 samples per cell (the default build takes ~10 s; wfsim_tpu's
    builder gives the same bits, tests/test_torch_maps.py)."""
    tt = build_nest_timing_tables(default_config(), n_samples=2000)
    pj = dataclasses.replace(pj, **{k: jnp.asarray(v) for k, v in zip(
        ('nest_inv_cdf', 'nest_fields', 'nest_energies'), tt)})
    pt = dataclasses.replace(pt, **{k: t32(v) for k, v in zip(
        ('nest_inv_cdf', 'nest_fields', 'nest_energies'), tt)})
    return (pj, dataclasses.replace(kj, s1_model_type='nest'),
            pt, dataclasses.replace(kt, s1_model_type='nest'))


@pytest.fixture(scope='module')
def physics(pattern_file):
    """Both packages' bundles of ``detector_physics`` with small NEST
    tables."""
    over = detector_physics_overrides(pattern_file)
    over['s1_model_type'] = 'simple'        # the tables are swapped in
    with jax_pattern_maps():
        cj = jax_default_config(**over)
        pj, kj = jax_build_params(cj, jax_load_config(cj)), \
            jax_build_constants(cj)
    c = default_config(**over)
    pt, kt = build_params(c, load_config(c), 'cpu'), build_constants(c)
    return with_small_nest_tables(pj, kj, pt, kt)


def nest_inst(ji):
    """NEST inputs on every instruction: the recoil classes ER, NR, alpha
    and LED, fields and energies on and off the table's grid."""
    n = len(ji['x'])
    ji['recoil'] = np.resize(np.array([7, 0, 6, 20, 8, 7], np.int32), n)
    ji['local_field'] = np.resize(np.array([82, 5, 300, 82, 2000, 47.5],
                                           np.float32), n)
    ji['e_dep'] = np.resize(np.array([27.4, 0.1, 400, 5, 1.0, 33.3],
                                     np.float32), n)
    pi = port_inst(ji)
    for k in ('recoil', 'local_field', 'e_dep'):
        pi[k] = t32(ji[k])
    return {k: jnp.asarray(v) for k, v in ji.items()}, pi


# ---------------------------------------------------------------------------
# entry points


def test_default_device_is_the_card():
    """No ``device`` argument means the card; without one, construction
    raises (no fallback to the CPU)."""
    cfg = default_config()
    if torch.cuda.is_available():
        assert Simulator(cfg).device.type == 'cuda'
        return
    for make in (Simulator, ChunkRawRecords, RawData):
        with pytest.raises(RuntimeError, match='CUDA'):
            make(cfg)


def test_s1_model_strings():
    assert s1.s1_models('simple') == {'simple'}
    assert s1.s1_models('nest') == {'nest'}
    assert s1.s1_models('simple+nest') == s1.s1_models('nest, simple') \
        == {'simple', 'nest'}
    assert s1.s1_models('custom+nest') == {'custom', 'nest'}
    assert s1.s1_models('simple+optical_propagation') \
        == {'simple', 'optical_propagation'}
    with pytest.raises(ValueError):
        s1.s1_models('nets')
    # optical propagation runs: without a spline it adds nothing, as in
    # wfsim_tpu (tests/test_torch_field_maps.py runs it with one)
    out = Simulator(default_config(s1_model_type='optical_propagation',
                                   seed=3), device='cpu').get_arrays(
        bench_instructions(2, 2000, 300))
    assert len(out['raw_records']) and len(out['truth']) == 4
    # garfield runs, given its table
    with pytest.raises(ValueError):
        load_config(default_config(s2_luminescence_model='garfield'))


def test_sqrt_f32_is_correctly_rounded():
    """The pass's square roots (inverse FDC, drift spread, diffusion) are
    correctly rounded on the CPU, as on the card and in wfsim_tpu: CPU
    torch's own float32 root is one ulp off for some values."""
    from wfsim_tpu_torch.models.common import sqrt_f32
    rng = np.random.default_rng(7)
    x = (10 ** rng.uniform(-6, 9, 200_000)).astype(np.float32)
    got = sqrt_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(jnp.sqrt(x)).view(np.int32))


# ---------------------------------------------------------------------------
# given-draw parity with wfsim_tpu


def test_nest_s1_pass_matches_jax_given_draws(physics):
    pj, kj, pt, kt = physics
    ji = jax_inst(6, 150_000, 5)
    jinst, pi = nest_inst(ji)
    key = jax.random.key(11)
    keys = jax.random.split(key, js1.N_S1_KEYS)
    pos = jnp.stack([jinst['x'], jinst['y'], jinst['z']], axis=1)
    n_hits = js1.s1_n_photon_hits(pj, kj, pos, jinst['amp'], jinst['valid'],
                                  keys[0])
    n = int(n_hits.sum())
    phj, trj, _ = js1.simulate_s1(pj, kj, jinst, key, capacity=n,
                                  n_truth_rows=6)
    draws = _np(dict(n_hits=n_hits, u_ch=jax.random.uniform(keys[1], (n,)),
                     u_nest=jax.random.uniform(keys[16], (n,)),
                     pmt=_jax_pmt_draws(keys[17:21], n)))
    draws['exp'] = draws['normal'] = None
    pht, trt, req = s1.s1_photon_pass(pt, kt, pi, draws, n_truth_rows=6)
    assert n > 5000 and int(req.sum()) == n

    ph_inst = np.repeat(np.arange(6), np.asarray(n_hits))
    dj = np.asarray(js1._nest_table_delays(
        pj, keys[16], js1._recoil_class(jinst['recoil'])[ph_inst],
        jinst['local_field'][ph_inst], jinst['e_dep'][ph_inst], n))
    dt = s1.nest_delays(*s1.nest_inputs(pt, kt, pi),
                        edges_from_counts(draws['n_hits']),
                        draws['u_nest']).numpy()
    np.testing.assert_array_equal(dj.view(np.int32), dt.view(np.int32))
    np.testing.assert_array_equal(np.asarray(phj['ch']), pht['ch'].numpy())
    np.testing.assert_array_equal(np.asarray(phj['t']), pht['t'].numpy())
    # NR, alpha and LED photons come earlier than ER ones at 82 V/cm
    assert dt.max() <= 1000.0 and dt.min() >= 0.0


def test_s2_pass_matches_jax_given_draws(physics):
    pj, kj, pt, kt = physics
    n_i = 6
    ji = jax_inst(n_i, 300, 6)
    ji['x'] *= np.float32(0.75)
    ji['y'] *= np.float32(0.75)
    jinst, pi = nest_inst(ji)
    key = jax.random.key(12)
    keys = jax.random.split(key, js2.N_S2_KEYS)
    st = js2._s2_electron_stage(pj, kj, jinst, keys, e_capacity=8192)
    E = int(st['total_e'])
    st = js2._s2_electron_stage(pj, kj, jinst, keys, e_capacity=E)
    n = int(st['n_ph_per_e'].sum())
    phj, trj, _ = js2.simulate_s2(pj, kj, jinst, key, e_capacity=E,
                                  capacity=n, n_truth_rows=n_i)
    draws = _np(dict(
        n_electron=st['n_electron'],
        e_exp=jax.random.exponential(keys[1], (E,)),
        e_normal=jax.random.normal(keys[2], (E,)),
        n_ph_per_e=st['n_ph_per_e'],
        diff_r=jax.random.normal(keys[8], (E,)),
        diff_a=jax.random.normal(keys[9], (E,)),
        aft_u0=jax.random.normal(keys[6], (n_i,)),
        aft_v=jax.random.normal(keys[7], (n_i,)),
        u_ch=jax.random.uniform(keys[5], (n,)),
        u_lum=jax.random.uniform(keys[10], (n,)),
        u_st=jax.random.uniform(keys[12], (n,)),
        exp_st=jax.random.exponential(keys[13], (n,)),
        t_spread=jax.random.normal(keys[14], (n,)),
        pmt=_jax_pmt_draws(keys[15:19], n)))
    z_t, pos_t = s2.s2_positions(pt, kt, pi)
    draws.update(z_obs=z_t, xy_obs=pos_t)
    pht, trt, req = s2.s2_photon_pass(pt, kt, pi, draws, n_truth_rows=n_i)
    assert n > 10000 and int(req.sum()) == n
    np.testing.assert_array_equal(np.asarray(trj['n_electron']),
                                  trt['n_electron'].numpy())

    # the diffused pattern, before the AFT smearing
    z_j, pos_j = js2.inverse_field_distortion_correction(
        pj, jinst['x'], jinst['y'], jinst['z'])
    pat_j = np.asarray(js2.s2_pattern_map_diffuse(
        pj, kj, (keys[8], keys[9]), st['n_electron'], z_j, pos_j,
        st['e_inst'], st['e_valid']))
    e_edges, _, ph_edges = s2.s2_edges(draws)
    pat_t = s2.pattern_diffuse(
        pt.s2_pattern, pos_t[:, 0].contiguous(), pos_t[:, 1].contiguous(),
        *s2.diffusion_inputs(pt, kt, z_t, pos_t), kt.tpc_radius ** 2, e_edges,
        draws['diff_r'], draws['diff_a'], 494).numpy()
    np.testing.assert_allclose(pat_t, pat_j, rtol=1e-6)

    # channels: equal wherever the port's target u * total lies farther
    # than 1e-6 * total from every edge of the port's CDF
    pat_st = s2.s2_pattern(pt, kt, z_t, pos_t, e_edges, draws)
    cdf = rs.cumsum_f64(pat_st, 1).numpy().astype(np.float64)
    ph_inst = np.repeat(np.repeat(np.arange(n_i),
                                  np.asarray(st['n_electron'])),
                        np.asarray(st['n_ph_per_e']))
    total = cdf[ph_inst, -1]
    target = draws['u_ch'].numpy() * total
    near = np.array([np.abs(cdf[i] - x).min() for i, x in
                     zip(ph_inst, target)]) <= 1e-6 * total
    chj, cht = np.asarray(phj['ch']), pht['ch'].numpy()
    np.testing.assert_array_equal(chj[~near], cht[~near])
    assert (chj != cht).sum() <= near.sum() <= 2e-3 * n

    # gas-gap luminescence times
    lj = np.asarray(js2.trunc_int(js2.luminescence_garfield_gasgap(
        pj, kj, keys[10], pos_j, jnp.asarray(ph_inst), jnp.ones(n, bool),
        n_i)))
    lt = s2.lumi_gasgap_times(pt.gg_inv_cdf, *s2.gasgap_rows(pt, pos_t),
                              ph_edges, draws['u_lum'],
                              t_max=pt.gg_t_max).numpy()
    assert np.all(np.abs(lj - lt) <= 1)
    assert (lj != lt).sum() <= 1e-4 * n, (lj != lt).sum()
    trunc_mismatch(phj['t'], pht['t'])

    for k in ('x_mean_electron', 'y_mean_electron'):
        np.testing.assert_allclose(trt[k].numpy(), np.asarray(trj[k]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize('n_photons,fits', [(2100, True), (2200, False)])
def test_gasgap_mean_fixed_point_range(n_photons, fits):
    """The gas-gap sampler's int64 fixed-point instruction sums hold up to
    about 2^31 ns summed over an instruction's photons: at 1 ms each, 2,100
    photons (9.02e18 of 9.22e18) give the exact mean, so every time is 0;
    2,200 would wrap and raise instead.  No host bound (``t_max`` inf):
    the exact check decides."""
    inv = torch.full((2, 16), 1e6)
    args = (inv, torch.tensor([0, 0]), torch.tensor([1, 1]),
            torch.tensor([0.3, 0.7]), torch.tensor([0, 5, 5 + n_photons]),
            torch.rand(5 + n_photons, generator=torch.Generator()
                       .manual_seed(3)))
    if fits:
        assert not s2.lumi_gasgap_times(*args, t_max=math.inf).any()
    else:
        with pytest.raises(OverflowError):
            s2.lumi_gasgap_times(*args, t_max=math.inf)


def test_fdc_truth_mean_electron():
    """The port's counterpart of tests/test_interfaces.py's FDC truth
    test: a constant 1.5 cm distortion at r = 30 cm."""
    c = default_config(field_distortion_model='inverse_fdc',
                       fdc_3d=['constant dummy', 1.5, []], seed=2)
    inst = bench_instructions(1)[1:]
    inst['x'], inst['y'], inst['z'] = 30., 0., -50.
    inst['amp'] = 100
    truth = []
    list(RawData(c, device='cpu').iter_windows(inst, truth_buffer=truth))
    row = [r for r in truth if r['type'] == 2][0]
    assert abs(row['x_mean_electron'] - 28.5) < 0.3
    assert abs(row['y_mean_electron']) < 0.3


# ---------------------------------------------------------------------------
# draw order


def test_detector_physics_draw_order(physics):
    """simulate_s1 and simulate_s2 of detector_physics equal their passes
    over draws made in this order: S1 counts, channel uniforms, NEST
    uniforms, PMT draws; S2 electrons, trapping exponentials, diffusion
    normals, Poisson photons per electron, then the radial and azimuthal
    diffusion normals per electron, the AFT normals per instruction, and
    per photon the channel, luminescence and singlet uniforms, the
    singlet/triplet exponential, the time-spread normal and the PMT
    draws."""
    _pj, _kj, pt, kt = physics
    _, inst = nest_inst(jax_inst(4, 20000, 3))
    ph, tr, _ = s1.simulate_s1(pt, kt, inst, torch.Generator().manual_seed(5),
                               n_truth_rows=4)
    gen = torch.Generator().manual_seed(5)
    n_hits = s1.s1_n_photon_hits(
        pt, kt, torch.stack([inst['x'], inst['y'], inst['z']], 1),
        inst['amp'], gen)
    n = int(n_hits.sum())
    d = dict(n_hits=n_hits, u_ch=torch.rand(n, generator=gen), exp=None,
             normal=None, u_nest=torch.rand(n, generator=gen),
             pmt=dict(tts=torch.randn(n, generator=gen),
                      dpe=torch.rand(n, generator=gen),
                      u1=torch.rand(n, generator=gen),
                      u2=torch.rand(n, generator=gen)))
    ph2, tr2, _ = s1.s1_photon_pass(pt, kt, inst, d, n_truth_rows=4)
    for a, b in ((ph, ph2), (tr, tr2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k

    _, inst = nest_inst(jax_inst(4, 200, 4))
    ph, tr, _ = s2.simulate_s2(pt, kt, inst, torch.Generator().manual_seed(6),
                               n_truth_rows=4)
    gen = torch.Generator().manual_seed(6)
    d = s2.s2_draws(pt, kt, inst, gen)
    after = torch.rand(1, generator=gen)
    gen = torch.Generator().manual_seed(6)
    mean, _ = s2.get_s2_drift_time_params(
        pt, kt, inst['z'], torch.stack([inst['x'], inst['y']], 1))
    cy = torch.exp(-mean / torch.tensor(kt.electron_lifetime_liquid)) \
        * kt.electron_extraction_yield
    n_el = rs.binomial(gen, inst['amp'], cy)
    assert torch.equal(n_el, d['n_electron'])
    assert d['diff_split'] == int(s2.diffuse_chunks(n_el))
    E = int(n_el.sum())
    for k, fn in (('e_exp', lambda m: torch.empty(m).exponential_(
            1.0, generator=gen)), ('e_normal', lambda m: torch.randn(
                m, generator=gen))):
        assert torch.equal(fn(E), d[k]), k
    _, pos = s2.s2_positions(pt, kt, inst)
    gain = pt.s2_correction(pos) * kt.s2_secondary_sc_gain \
        / torch.tensor(1 + kt.p_double_pe_emision)
    assert torch.equal(rs.poisson(gen, torch.repeat_interleave(gain, n_el)),
                       d['n_ph_per_e'])
    n = int(d['n_ph_per_e'].sum())
    for k, m, fn in (('diff_r', E, torch.randn), ('diff_a', E, torch.randn),
                     ('aft_u0', 4, torch.randn), ('aft_v', 4, torch.randn),
                     ('u_ch', n, torch.rand), ('u_lum', n, torch.rand),
                     ('u_st', n, torch.rand)):
        assert torch.equal(fn(m, generator=gen), d[k]), k
    assert torch.equal(torch.empty(n).exponential_(1.0, generator=gen),
                       d['exp_st'])
    assert torch.equal(torch.randn(n, generator=gen), d['t_spread'])
    for k, fn in (('tts', torch.randn), ('dpe', torch.rand),
                  ('u1', torch.rand), ('u2', torch.rand)):
        assert torch.equal(fn(n, generator=gen), d['pmt'][k]), k
    assert torch.equal(torch.rand(1, generator=gen), after)
    ph2, tr2, _ = s2.s2_photon_pass(pt, kt, inst, d, n_truth_rows=4)
    for a, b in ((ph, ph2), (tr, tr2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


#: integer sums of the default config's S1 and S2 passes at generator seed
#: 2026 on bench_instructions(3): (photons, sum t, sum ch, DPE photons,
#: electrons, the generator's next uniform); the values of the port before
#: the detector-physics switches existed
DEFAULT_STREAM = {
    's1': (41, 196003324, 10610, 5, 0, 0.8903810977935791),
    's2': (9254, 48117952633, 2272656, 1974, 535, 0.8442102074623108),
}


@pytest.mark.parametrize('kind', ['s1', 's2'])
def test_default_stream_is_pinned(kind):
    c = default_config()
    p, k = build_params(c, load_config(c), 'cpu'), build_constants(c)
    inst = bench_instructions(3)
    sel = inst[inst['type'] == (1 if kind == 's1' else 2)]
    x = dict(time=t32((sel['time'] - sel['time'].min()).astype(np.int32)),
             x=t32(sel['x'].astype(np.float32)),
             y=t32(sel['y'].astype(np.float32)),
             z=t32(sel['z'].astype(np.float32)),
             amp=t32(sel['amp'].astype(np.int32)), truth_row=torch.arange(3))
    gen = torch.Generator().manual_seed(2026)
    sim = s1.simulate_s1 if kind == 's1' else s2.simulate_s2
    ph, tr, _ = sim(p, k, x, gen, n_truth_rows=3)
    got = (int(ph['t'].shape[0]), int(ph['t'].long().sum()),
           int(ph['ch'].long().sum()), int(ph['is_dpe'].sum()),
           int(tr['n_electron'].sum()), float(torch.rand(1, generator=gen)))
    assert got == DEFAULT_STREAM[kind]
