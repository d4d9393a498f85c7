"""The ``timing_models`` configuration of wfsim_tpu_torch (the ``custom``
S1 timing model, K15, and the ``garfield`` wire-table luminescence, K13c)
against wfsim_tpu on the CPU.

Tolerances, per quantity:

- given the same draws (JAX's regenerated from its keys): the custom
  delays bitwise after the truncation to int the S1 pass applies,
  recombination uniforms of exactly 0 included (JAX moves them to 1e-12,
  the port clamps them there); the garfield luminescence times exact in
  int32 in both wire-distance modes; the table's int mean equal;
- the S1 pass with ``simple+custom`` timing: channels and flags exact,
  times as ``trunc_mismatch`` (at most 1 in 10^3 photons 1 ns off);
- the garfield file: the rows of the liquid level nearest the configured
  one, equal to wfsim_tpu's selection;
- an 8-event slice: per-type photon counts within 5 sigma of the 8-event
  spread, ordered S1 times by recoil class, positive S2 time spreads;
- the numpy oracles of tests/test_reference_distributions.py on the
  port's twins: two-sample KS at p > 0.01.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from wfsim_tpu import units
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.interface.simulator import Simulator as JaxSimulator
from wfsim_tpu.models import s1 as js1, s2 as js2
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import Simulator
from wfsim_tpu_torch.config import default_config, timing_models_overrides
from wfsim_tpu_torch.interface import timing_models_instructions
from wfsim_tpu_torch.models import s1, s2
from wfsim_tpu_torch.models.params import (build_params, build_constants,
                                           table_mean_int)
from wfsim_tpu_torch.ops.segment import edges_from_counts
from wfsim_tpu_torch.resources import load_config
from wfsim_tpu_torch.resources.synthetic import (GARFIELD_LEVELS,
                                                 synthetic_garfield_table,
                                                 write_garfield_table)

from .test_torch_photon_passes import (jax_inst, port_inst, _np,
                                       _jax_pmt_draws, t32, channels_agree,
                                       compare_truth)
from .test_reference_distributions import ks_ok, np_singlet_triplet
from .test_torch_physics import trunc_mismatch
from .test_torch_slice import _spread_check
from wfsim_tpu_torch.ops import randsample as rs

N_KS = 40_000


def wire_table():
    """wfsim_tpu's test table (tests/test_models.py:232-236)."""
    rng = np.random.default_rng(0)
    x_axis = np.linspace(-0.25, 0.25, 11)
    table = rng.exponential(300, (11, 500)) + np.abs(x_axis)[:, None] * 1000
    return {'t': table.astype(np.float32), 'x': x_axis.astype(np.float32)}


def bundles(**over):
    cj = jax_default_config(**over)
    c = default_config(**over)
    return ((jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (build_params(c, load_config(c), 'cpu'), build_constants(c)))


@pytest.fixture(scope='module')
def custom_bundles():
    return bundles(s1_model_type='simple+custom')


# ---------------------------------------------------------------------------
# K15: custom S1 delays


def test_s1_model_strings_with_custom():
    assert s1.s1_models('custom') == {'custom'}
    assert s1.s1_models('custom+nest') == s1.s1_models('nest,custom') \
        == {'custom', 'nest'}


def test_reco_uniform_is_jax_minval_transform():
    key = jax.random.key(3)
    raw = np.asarray(jax.random.uniform(key, (50_000,)))
    want = np.asarray(jax.random.uniform(key, (50_000,), minval=1e-12,
                                         maxval=1.0))
    got = s1.reco_uniform(t32(raw)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert s1.reco_uniform(torch.zeros(1)).item() == np.float32(1e-12)


def test_custom_delays_match_jax_given_draws(custom_bundles, monkeypatch):
    """Every class (ER 7 and 8, NR, alpha, LED, an instruction without
    photons), JAX's eleven key streams regenerated, and raw recombination
    uniforms of 0 injected on both sides."""
    (_, kj), (_, kt) = custom_bundles
    rng = np.random.default_rng(4)
    recoil = np.resize(np.array([7, 0, 6, 20, 8], np.int32), 40)
    counts = rng.integers(0, 1500, 40)
    counts[3] = 0
    n = int(counts.sum())
    ph_inst = np.repeat(np.arange(40), counts)
    keys = jax.random.split(jax.random.key(5), 11)
    zero_at = np.arange(0, n, 97)

    real_uniform = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if minval == 0.0 and maxval == 1.0:
            return real_uniform(key, shape, dtype)
        raw = real_uniform(key, shape, dtype).at[zero_at].set(0.0)
        lo, hi = jnp.float32(minval), jnp.float32(maxval)
        return jnp.maximum(lo, raw * (hi - lo) + lo)
    # the transform is jax.random.uniform's own where nothing is injected
    np.testing.assert_array_equal(
        np.asarray(real_uniform(keys[3], (n,), minval=1e-12, maxval=1.0)),
        np.asarray(jnp.maximum(jnp.float32(1e-12), real_uniform(
            keys[3], (n,)) * jnp.float32(1.0) + jnp.float32(1e-12))))
    monkeypatch.setattr(jax.random, 'uniform', uniform)
    cls_j = js1._recoil_class(jnp.asarray(recoil))[ph_inst]
    dj = np.asarray(js1._custom_recoil_delays(kj, keys, cls_j, n))

    draws = {}
    for k, key in zip(s1.CUSTOM_DRAWS, keys):
        draws[k] = (jax.random.exponential(key, (n,)) if k.startswith('exp')
                    else real_uniform(key, (n,)))
    draws['u_reco'] = draws['u_reco'].at[zero_at].set(0.0)
    draws = _np(draws)
    assert int((draws['u_reco'] == 0).sum()) == len(zero_at)
    edges = edges_from_counts(t32(counts))
    dt = s1.custom_delays(s1.recoil_class(t32(recoil)), edges, draws,
                          const=kt).numpy()
    np.testing.assert_array_equal(np.trunc(dj).astype(np.int32),
                                  np.trunc(dt).astype(np.int32))
    # the injected zeros hit non-primary ER photons at the 1000 ns cap
    er = np.isin(recoil[ph_inst], (7, 8))
    assert np.any(dt[zero_at][er[zero_at]] >= 1000.0)
    for c in range(4):
        assert (s1.recoil_class(t32(recoil))[t32(ph_inst)] == c).sum() > 1000


def test_custom_s1_pass_matches_jax_given_draws(custom_bundles):
    (pj, kj), (pt, kt) = custom_bundles
    ji = jax_inst(8, 150_000, 5)
    ji['recoil'] = np.resize(np.array([7, 0, 6, 20], np.int32), 8)
    jinst = {k: jnp.asarray(v) for k, v in ji.items()}
    key = jax.random.key(13)
    keys = jax.random.split(key, js1.N_S1_KEYS)
    pos = jnp.stack([jinst['x'], jinst['y'], jinst['z']], axis=1)
    n_hits = js1.s1_n_photon_hits(pj, kj, pos, jinst['amp'], jinst['valid'],
                                  keys[0])
    n = int(n_hits.sum())
    phj, trj, _ = js1.simulate_s1(pj, kj, jinst, key, capacity=n,
                                  n_truth_rows=8)
    custom = {k: (jax.random.exponential(kk, (n,)) if k.startswith('exp')
                  else jax.random.uniform(kk, (n,)))
              for k, kk in zip(s1.CUSTOM_DRAWS, keys[5:16])}
    custom['u_reco'] = jax.random.uniform(keys[8], (n,), minval=1e-12,
                                          maxval=1.0)
    draws = _np(dict(n_hits=n_hits,
                     u_ch=jax.random.uniform(keys[1], (n,)),
                     exp=jax.random.exponential(keys[3], (n,)),
                     normal=jax.random.normal(keys[4], (n,)),
                     custom=custom, pmt=_jax_pmt_draws(keys[17:21], n)))
    pi = port_inst(ji)
    pi['recoil'] = t32(ji['recoil'])
    pht, trt, req = s1.s1_photon_pass(pt, kt, pi, draws, n_truth_rows=8)
    assert n > 5000 and int(req.sum()) == n
    pattern = s1.masked_pattern(pt, pt.s1_pattern,
                                torch.stack([t32(ji['x']), t32(ji['y']),
                                             t32(ji['z'])], 1)).numpy()
    ph_inst = np.repeat(np.arange(8), np.asarray(n_hits))
    channels_agree(np.asarray(phj['ch']), pht['ch'].numpy(),
                   np.asarray(jnp.cumsum(jnp.asarray(pattern), axis=1)),
                   rs.cumsum_f64(t32(pattern), 1).numpy(), ph_inst,
                   draws['u_ch'].numpy())
    trunc_mismatch(phj['t'], pht['t'])
    for k in ('is_dpe', 'valid'):
        np.testing.assert_array_equal(np.asarray(phj[k]), pht[k].numpy(), k)
    compare_truth(trj, trt, 8)


def test_custom_and_nest_terms_truncate_apart():
    """``custom+nest`` adds trunc(custom) and trunc(nest), in wfsim_tpu's
    order, not trunc(custom + nest)."""
    time = torch.tensor([100, 200], dtype=torch.int32)
    edges = torch.tensor([0, 2, 3])
    rows = torch.tensor([4, 9])
    custom = torch.tensor([0.6, 1.7, 2.5])
    nest = torch.tensor([0.6, 0.4, 3.9])
    t, ph_row = s1.s1_photon_times(time, edges, rows, None, None, nest,
                                   custom, decay_time=1.0, decay_spread=1.0)
    assert t.tolist() == [100, 101, 205]
    assert ph_row.tolist() == [4, 4, 9]


# ---------------------------------------------------------------------------
# K13c: garfield wire-table luminescence


@pytest.mark.parametrize('confine', [-1.0, 0.1])
def test_garfield_times_match_jax_given_draws(confine):
    """Both wire-distance modes: the rotated y modulo the pitch (positions
    on both sides of the wires and of the axes), and a uniform within
    +-confine.  Times exact in int32, the int table mean equal."""
    over = dict(s2_luminescence_model='garfield',
                s2_luminescence=wire_table(),
                s2_garfield_confine_position=confine)
    (pj, kj), (pt, kt) = bundles(**over)
    assert int(jnp.mean(pj.garfield_t).astype(jnp.int32)) == pt.garfield_avgt
    for f in ('garfield_t', 'garfield_x'):
        np.testing.assert_array_equal(np.asarray(getattr(pj, f)),
                                      getattr(pt, f).numpy())
    rng = np.random.default_rng(6)
    n_i = 300
    r = np.sqrt(rng.uniform(0, 66 ** 2, n_i))
    phi = rng.uniform(-np.pi, np.pi, n_i)
    xy = np.stack([r * np.cos(phi), r * np.sin(phi)], 1).astype(np.float32)
    xy[:4] = [[0, 0], [0.25, -0.25], [-0.7071, 0.7071], [12, -7]]
    counts = rng.integers(0, 400, n_i)
    counts[5] = 0
    n = int(counts.sum())
    ph_inst = np.repeat(np.arange(n_i), counts)
    k1, k2 = jax.random.split(jax.random.key(21))
    tj = np.asarray(js2.luminescence_garfield(
        pj, kj, (k1, k2), jnp.asarray(xy), jnp.asarray(ph_inst),
        jnp.ones(n, bool)))
    cols = t32(jax.random.randint(k2, (n,), 0, 500)).long()
    u_wire = (t32(jax.random.uniform(k1, (n_i,))) if confine > 0 else None)
    tt = s2.lumi_garfield_times(
        pt.garfield_t, pt.garfield_x, t32(xy), edges_from_counts(
            t32(counts)), cols, u_wire, avgt=pt.garfield_avgt,
        tilt=kt.anode_xaxis_angle, pitch=kt.anode_pitch,
        confine=kt.s2_garfield_confine_position)
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tj, tt.numpy())
    assert len(np.unique(tt.numpy())) > 100


def test_garfield_tilt_coefficients_match_jax():
    s, c = s2.tilt_coefficients(np.pi / 4)
    assert s == float(jnp.sin(np.pi / 4)) and c == float(jnp.cos(np.pi / 4))
    assert s == float(jax.jit(lambda: jnp.sin(np.pi / 4))())


def test_garfield_file_selects_nearest_liquid_level(tmp_path):
    path = write_garfield_table(tmp_path / 'garfield.npz', 1234)
    over = timing_models_overrides(path)
    c = default_config(**over)
    ours = load_config(c).s2_luminescence
    ref = jax_load_config(jax_default_config(**over)).s2_luminescence
    for f in ('ll', 'x', 't'):
        np.testing.assert_array_equal(ours[f], ref[f])
    want = synthetic_garfield_table(1234)
    assert abs(c['gate_to_anode_distance'] - c['elr_gas_gap_length']
               - GARFIELD_LEVELS[1][0]) < 1e-9
    np.testing.assert_array_equal(ours['t'], want['t'])
    np.testing.assert_array_equal(ours['x'], want['x'])
    # another gas gap picks another level
    deep = load_config(default_config(**over, elr_gas_gap_length=0.32))
    np.testing.assert_array_equal(deep.s2_luminescence['t'],
                                  want['t'] * np.float32(0.8))
    with pytest.raises(FileNotFoundError):
        load_config(default_config(**timing_models_overrides('nowhere.npz')))
    with pytest.raises(ValueError):
        load_config(default_config(s2_luminescence_model='garfield'))


@pytest.mark.parametrize('table', ['test', 'smoke'])
def test_garfield_avgt_matches_jax(table):
    """The int mean on wfsim_tpu's test table and on the table the
    timing_models runs read (seed 1234)."""
    t = (wire_table() if table == 'test'
         else synthetic_garfield_table(1234))['t']
    assert table_mean_int(t) == int(jnp.mean(jnp.asarray(t)).astype(
        jnp.int32))


# ---------------------------------------------------------------------------
# the timing_models slice end to end


N_EVENTS = 8


@pytest.fixture(scope='module')
def slice_runs(tmp_path_factory):
    path = write_garfield_table(
        tmp_path_factory.mktemp('tm') / 'garfield.npz', 1234)
    inst = timing_models_instructions(N_EVENTS)
    over = timing_models_overrides(path)
    ours = Simulator(default_config(seed=1234, chunk_size=100, **over),
                     device='cpu').get_arrays(inst)
    ref = JaxSimulator(jax_default_config(seed=1234, chunk_size=100,
                                          **over)).get_arrays(inst)
    return inst, ours, ref


def test_timing_models_slice(slice_runs):
    inst, ours, ref = slice_runs
    for out in (ours, ref):
        truth = out['truth']
        assert len(truth) == len(inst)
        assert (truth['type'] == 1).sum() == (truth['type'] == 2).sum() \
            == N_EVENTS
        s1_rows = truth[truth['type'] == 1]
        dt = s1_rows['t_mean_photon'] - s1_rows['time']
        by = {r: dt[s1_rows['recoil'] == r].mean() for r in (7, 0, 6, 20)}
        assert by[0] < by[7], by          # NR faster than ER
        s2_rows = truth[truth['type'] == 2]
        assert np.all(s2_rows['t_sigma_photon'][s2_rows['n_photon'] > 0] > 0)
        rr = out['raw_records']
        assert len(rr) > 1000 and np.all(np.diff(rr['time']) >= 0)
    for ptype in (1, 2):
        for field in ('n_photon', 'n_pe', 'raw_area'):
            _spread_check(ours['truth'][field][ours['truth']['type'] == ptype],
                          ref['truth'][field][ref['truth']['type'] == ptype])
    for t in (ours['truth'], ref['truth']):
        s2_rows = t[t['type'] == 2]
        # the garfield times: exponential(300 ns) around the table mean
        assert np.all((s2_rows['t_sigma_photon'] > 200)
                      & (s2_rows['t_sigma_photon'] < 2000))


# ---------------------------------------------------------------------------
# the numpy oracles of tests/test_reference_distributions.py on the twins


def _port_custom(recoil_cls, seed):
    c = default_config(s1_model_type='custom')
    const = build_constants(c)
    gen = torch.Generator().manual_seed(seed)
    draws = {k: (torch.empty(N_KS).exponential_(1.0, generator=gen)
                 if k.startswith('exp') else torch.rand(N_KS, generator=gen))
             for k in s1.CUSTOM_DRAWS}
    draws['u_reco'] = s1.reco_uniform(draws['u_reco'])
    t = s1.custom_delays(torch.tensor([recoil_cls]),
                         torch.tensor([0, N_KS]), draws, const=const)
    return c, const, np.trunc(t.numpy())


def test_ks_s1_er():
    c, const, ours = _port_custom(0, 7)
    density = 1.872452802978054e+30 / (units.g / units.cm ** 3)
    excfrac = 0.4 - 0.11131 * density - 0.0026651 * density ** 2
    excfrac = 1 / (1 + excfrac)
    excfrac /= 1 - (1 - excfrac) * (1 - c['s1_ER_recombination_fraction'])
    efield = c['drift_field'] / (units.V / units.cm)
    reco_time = 3.5 / 0.18 * (1 / 20 + 0.41) * np.exp(-0.009 * efield)
    assert abs(const.er_primary_excimer_fraction - excfrac) < 1e-9
    assert abs(const.er_recombination_time - reco_time) < 1e-6
    rng = np.random.default_rng(11)
    primary = rng.random(N_KS) < excfrac
    t = np.where(primary, 0.0, reco_time)
    n_sec = int((~primary).sum())
    t[primary] += np_singlet_triplet(
        rng, int(primary.sum()), c['s1_ER_primary_singlet_fraction'],
        c['singlet_lifetime_liquid'], c['triplet_lifetime_liquid'])
    t[~primary] *= 1 / (-1 + 1 / rng.random(n_sec))
    t[~primary] = np.clip(t[~primary], 0, 1000)
    t[~primary] += np_singlet_triplet(
        rng, n_sec, c['s1_ER_secondary_singlet_fraction'],
        c['singlet_lifetime_liquid'], c['triplet_lifetime_liquid'])
    ks_ok(ours, np.trunc(t))


@pytest.mark.parametrize('cls,frac_key,seed', [
    (1, 's1_NR_singlet_fraction', 12),
    (2, 's1_ER_alpha_singlet_fraction', 13)])
def test_ks_s1_singlet_triplet_classes(cls, frac_key, seed):
    c, _, ours = _port_custom(cls, seed)
    rng = np.random.default_rng(seed)
    ks_ok(ours, np_singlet_triplet(rng, N_KS, c[frac_key],
                                   c['singlet_lifetime_liquid'],
                                   c['triplet_lifetime_liquid']))


def test_ks_s1_led():
    c, _, ours = _port_custom(3, 14)
    rng = np.random.default_rng(14)
    ks_ok(ours, np.trunc(rng.uniform(0, c['led_pulse_length'], N_KS)))


def test_ks_luminescence_garfield():
    """The wire-distance table draw (oracle of reference s2.py:380-409)."""
    rng0 = np.random.default_rng(3)
    x_axis = np.linspace(-0.25, 0.25, 11)
    table = (rng0.exponential(300, (11, 500))
             + np.abs(x_axis)[:, None] * 1000)
    c = default_config(s2_luminescence_model='garfield',
                       s2_luminescence={'t': table.astype(np.float32),
                                        'x': x_axis.astype(np.float32)})
    p, k = build_params(c, load_config(c), 'cpu'), build_constants(c)
    xy = torch.tensor([[12.0, -7.0]])
    cols = torch.randint(500, (N_KS,), generator=torch.Generator()
                         .manual_seed(24))
    ours = s2.lumi_garfield_times(
        p.garfield_t, p.garfield_x, xy, torch.tensor([0, N_KS]), cols,
        avgt=p.garfield_avgt, tilt=k.anode_xaxis_angle, pitch=k.anode_pitch,
        confine=k.s2_garfield_confine_position).numpy()
    tilt, pitch = c.get('anode_xaxis_angle', np.pi / 4), 0.5
    rot = np.array([[np.cos(tilt), -np.sin(tilt)],
                    [np.sin(tilt), np.cos(tilt)]])
    d = (np.matmul(xy.numpy(), rot)[:, 1] + pitch / 2) % pitch - pitch / 2
    row = int(np.argmin(np.abs(d[0] - x_axis)))
    rng = np.random.default_rng(18)
    cols_o = rng.integers(0, table.shape[1], N_KS)
    avgt = int(np.average(table.astype(np.float32)))
    oracle = table.astype(np.float32)[row, cols_o].astype(np.int64) - avgt
    ks_ok(ours, oracle)
