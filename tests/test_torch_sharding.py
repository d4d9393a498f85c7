"""The multi-device path of wfsim_tpu_torch (the port of
tests/test_sharding.py): the channel-block kernel's twin against
wfsim_tpu's ``photons_to_waveform``, the per-batch generators, the
explicit step (K14) and ``Simulator(mesh=...)`` over gloo ranks on the
CPU, and the misuse the mesh path refuses.

Tolerances: bitwise everywhere.  The twin adds the same float32 products
in another order than JAX (photon by photon instead of per histogram bin,
then a contraction), so an ADC value within an f32 ulp of a .5 tie may
round the other way; such tie samples are counted and must be 0 at these
seeds.  Sharded runs must equal the single-device run exactly: each
batch draws from its own generator, and the DAQ chain is integer.

The ranks are processes started with ``spawn`` (tests/torch_dist_workers.py),
each joined with a limit of its own; the process groups meet through a
file in ``tmp_path``, so parallel test workers never share a port.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.distributed as dist

from wfsim_tpu.ops.waveform import photons_to_waveform as jax_waveform

from wfsim_tpu_torch import RawData, Simulator
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.dtypes import instruction_dtype
from wfsim_tpu_torch.interface import step_instructions
from wfsim_tpu_torch.models.params import build_constants
from wfsim_tpu_torch.ops.waveform import make_templates, superpose_block
from wfsim_tpu_torch.parallel import make_mesh
from wfsim_tpu_torch.parallel.sharding import block_photons

from .reference_semantics import scatter_spe
from .torch_dist_workers import (mesh_rank, one_rank_group, run_ranks,
                                 run_step)

T = 1024


# ---------------------------------------------------------------------------
# (a) the channel-block kernel's twin against wfsim_tpu


def block_inputs(seed, n=6000):
    """Seeded photons over every channel, some dropped (channel -1 or
    invalid) and some starting before or past a T-sample grid."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-2_000, T * 10 + 2_000, n).astype(np.int32)
    ch = rng.integers(0, 494, n).astype(np.int32)
    ch[rng.random(n) < 0.01] = -1
    gain = (2e6 * np.clip(rng.normal(1.0, 0.4, n), 0.05, None)).astype(
        np.float32)
    valid = rng.random(n) < 0.98
    return t, ch, gain, valid


@pytest.mark.parametrize('n_ch_shards,block', [(1, 0), (2, 0), (2, 1)])
def test_superpose_block_matches_jax(n_ch_shards, block):
    """sharding.py:101-117 on one channel block: wfsim_tpu's
    photons_to_waveform + ``-round`` and the bottom-array partial sum
    against block_photons + superpose_block (the twin on the CPU)."""
    c = default_config()
    const = build_constants(c)
    C, n_top, dt = const.n_tpc_pmts, const.n_top_pmts, const.sample_duration
    C_loc = -(-C // n_ch_shards)
    ch_block = block * C_loc
    templates = make_templates(c['pe_pulse_ts'], c['pe_pulse_ys'])
    t, ch, gain, valid = block_inputs(20 + 3 * n_ch_shards + block)

    ch_loc = ch - ch_block
    in_block = (ch_loc >= 0) & (ch_loc < C_loc)
    W = jax_waveform(jnp.asarray(t), jnp.asarray(np.where(in_block, ch_loc,
                                                          0)),
                     jnp.asarray(gain), jnp.asarray(valid & in_block), 0,
                     jnp.asarray(templates), n_channels=C_loc, n_samples=T,
                     sample_duration=dt)
    adc_j = np.asarray((-jnp.round(W * const.current_2_adc)).astype(
        jnp.int32))
    ch_ids = ch_block + np.arange(C_loc)
    bottom = (ch_ids >= n_top) & (ch_ids < C)
    sum_j = np.where(bottom[:, None], adc_j, 0).sum(axis=0)

    ph = {k: torch.from_numpy(v) for k, v in
          dict(t=t, ch=ch, gain=gain, valid=valid).items()}
    bp = block_photons(ph, torch.zeros(len(t), dtype=torch.int64),
                       n_blocks=1, ch_block=ch_block, n_channels=C_loc,
                       n_samples=T, sample_duration=dt)
    adc, sums = superpose_block(
        bp['t'], bp['gain'], bp['row_ptr'], torch.from_numpy(templates),
        n_channels=C_loc, ch_block=ch_block, n_top=n_top, n_tpc=C,
        current_2_adc=const.current_2_adc, n_samples=T)
    adc, sums = adc.numpy(), sums.numpy()

    bad = np.argwhere(adc != adc_j)
    ties = 0
    if len(bad):
        keep = valid & in_block & (t >= 0)
        W64 = scatter_spe(t[keep], ch_loc[keep], gain[keep], 0, C_loc, T,
                          templates, dt)
        for cc, u in bad:
            x = W64[cc, u] * c['current_2_adc']
            ties += abs(x - np.floor(x) - 0.5) < 1e-4
    assert len(bad) == 0, f'{len(bad)} samples differ, {ties} of them ties'
    assert adc.shape == (C_loc, T) and adc.dtype == np.int32
    assert np.count_nonzero(adc) > 10_000
    np.testing.assert_array_equal(sums[0], sum_j)
    assert np.any(sum_j != 0) == bool(bottom.any())


# ---------------------------------------------------------------------------
# (b) one generator per batch


def test_batch_draws_do_not_depend_on_earlier_batches():
    """A batch's draws are the same whether it runs after three other
    batches or alone at the same counter (wfsim_tpu's fold_in(key,
    counter)); another counter draws other numbers."""
    inst = bench_12()
    c = default_config(seed=3)
    order = np.argsort(inst['time'], kind='stable')

    def run(batches, first):
        rd = RawData(c, device='cpu')
        rd._batch_ctr = first
        truth = []
        rd._simulate_batches(inst, batches, truth)
        return rd, truth

    s1, s2 = RawData(c, device='cpu')._sim_batch_list(inst, order)
    assert s1[0] == 's1' and s2[0] == 's2'
    target = ('s2', s2[1][:5])
    after, truth_a = run([s1, s2, ('s1', s1[1][:4]), target], 0)
    alone, truth_b = run([target], 3)
    other, _ = run([target], 4)
    last = max(after._buffers)
    for k in ('t', 'ch', 'gain'):
        assert torch.equal(after._buffers[last][k], alone._buffers[0][k]), k
    assert [repr(r) for r in truth_a[-5:]] == [repr(r) for r in truth_b]
    assert not torch.equal(other._buffers[0]['t'], alone._buffers[0]['t'])


# ---------------------------------------------------------------------------
# the ranks: (c) the step, 2x1, 1x2 and 2x2 against 1x1; (d)
# Simulator(mesh=...) against the single-device run


def bench_12():
    """The instructions of tests/test_sharding.py:60-71."""
    n = 12
    rng = np.random.default_rng(5)
    inst = np.zeros(2 * n, dtype=instruction_dtype)
    inst['event_number'] = np.repeat(np.arange(n), 2)
    inst['type'] = np.tile([1, 2], n)
    inst['time'] = np.repeat((np.arange(n) + 1) * 2_000_000, 2)
    r = np.sqrt(rng.uniform(0, 45 ** 2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    inst['x'] = np.repeat(r * np.cos(th), 2)
    inst['y'] = np.repeat(r * np.sin(th), 2)
    inst['z'] = np.repeat(rng.uniform(-80, -20, n), 2)
    inst['amp'] = np.tile([600, 80], n)
    inst['recoil'] = 7
    return inst


STEP_KW = dict(inst_per_shard=8, n_samples=T, seed=1234)

CONFIGS = {
    'default': dict(seed=11),
    # two super-batches: the summaries that seed the electron afterpulses
    # are broadcast, and the host generator keeps its order
    'realistic': dict(seed=11, enable_noise=True, enable_pmt_afterpulses=True,
                      enable_electron_afterpulses=True, pipeline_depth=3,
                      pipeline_min_batch=4),
}


@pytest.fixture(scope='module')
def mesh_runs(tmp_path_factory):
    """Two gloo ranks run the step at 2 x 1 and 1 x 2 and both CONFIGS over
    make_mesh(2, 1); four ranks the step at 2 x 2.  Meanwhile this process
    makes the references: the step at 1 x 1 (two blocks of 8
    instructions) and the single-device Simulator runs."""
    c = default_config()
    step_inst = step_instructions(c, n_blocks=2, per_block=8, n_samples=T)
    configs = {name: default_config(**kw) for name, kw in CONFIGS.items()}
    inst = bench_12()
    tmp = tmp_path_factory.mktemp('mesh')

    def references():
        with one_rank_group(tmp):
            step, _mesh = run_step(c, step_inst, 1, 1, **STEP_KW)
        sims = {}
        for name, config in configs.items():
            sim = Simulator(config, device='cpu')
            sims[name] = dict(out=sim.get_arrays(inst.copy()),
                              diag=sim.sim.rawdata.diag.summary())
        return dict(step=step, sims=sims)

    two, ref = run_ranks(mesh_rank, 2, tmp, c, step_inst, [(2, 1), (1, 2)],
                         STEP_KW, configs, inst, meanwhile=references)
    four, _ = run_ranks(mesh_rank, 4, tmp, c, step_inst, [(2, 2)], STEP_KW,
                        {}, inst)
    return dict(config=c, ref=ref, ranks={2: two, 4: four})


@pytest.mark.parametrize('n_ev,n_ch', [(2, 1), (1, 2), (2, 2)])
def test_sharded_step_matches_single_device(mesh_runs, n_ev, n_ch):
    ref = mesh_runs['ref']['step']
    const = build_constants(mesh_runs['config'])
    C, n_top = const.n_tpc_pmts, const.n_top_pmts
    n_photon, n_pe = ref['totals']
    assert n_pe >= n_photon > 0
    assert ref['adc'].shape == (2, C, T)
    # the sum row is the bottom channels' sum of the (whole) grid
    np.testing.assert_array_equal(ref['sum_signal'],
                                  ref['adc'][:, n_top:].sum(axis=1))
    assert np.count_nonzero(ref['sum_signal']) > T // 2

    outs = [r['steps'][n_ev, n_ch] for r in mesh_runs['ranks'][n_ev * n_ch]]
    B, C_loc = 2 // n_ev, -(-C // n_ch)
    blocks = [[None] * n_ch for _ in range(n_ev)]
    for rank, out in enumerate(outs):
        e, j = out['events_index'], out['channel_index']
        assert (e, j) == divmod(rank, n_ch)
        assert out['adc'].shape == (B, C_loc, T)
        blocks[e][j] = out['adc']
        np.testing.assert_array_equal(out['sum_signal'],
                                      ref['sum_signal'][e * B:(e + 1) * B])
        np.testing.assert_array_equal(out['totals'], ref['totals'])
        # only the sum row and the totals cross ranks
        assert out['all_reduces'] == [('channels', B * T * 4),
                                      ('events', 16)]
        assert (out['pipeline_refused'] is not None) == (n_ch > 1)
    grid = np.concatenate([np.concatenate(row, axis=1) for row in blocks])
    np.testing.assert_array_equal(grid[:, :C], ref['adc'])
    assert not grid[:, C:].any()


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_simulator_mesh_matches_single_device(mesh_runs, name):
    """Every rank returns the records and truth of the single-device run,
    bitwise (tests/test_sharding.py:51-91)."""
    single = mesh_runs['ref']['sims'][name]
    ref = single['out']
    assert len(ref['raw_records']) > 0 and len(ref['truth']) >= 24
    for rank in mesh_runs['ranks'][2]:
        got = rank['sims'][name]
        assert sorted(got['out']) == sorted(ref)
        for k in ref:
            assert got['out'][k].tobytes() == ref[k].tobytes(), k
        assert got['diag']['broadcast_bytes'] > 0
        assert got['diag']['super_batches'] == single['diag']['super_batches']
    if name == 'realistic':
        assert single['diag']['super_batches'] >= 2
        assert np.count_nonzero(ref['truth']['type'] == 4) > 0


# ---------------------------------------------------------------------------
# (e) what the mesh path refuses


def test_mesh_misuse_raises(tmp_path):
    """No process group, no 'events' dim, sizes that are not the world, a
    run without a seed; 'channels' > 1 is refused in the 1 x 2 step test
    (it needs two ranks)."""
    from torch.distributed.device_mesh import DeviceMesh
    c = default_config(seed=2)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='process group'):
        make_mesh(1, 1, device_type='cpu')
    with one_rank_group(tmp_path):
        mesh = make_mesh(1, 1, device_type='cpu')
        flat = DeviceMesh('cpu', [0], mesh_dim_names=('replica',))
        with pytest.raises(ValueError, match='events'):
            RawData(c, device='cpu', mesh=flat)
        with pytest.raises(ValueError, match='!= 1 ranks'):
            make_mesh(2, 1, device_type='cpu')
        with pytest.raises(ValueError, match='seed'):
            RawData(default_config(seed=0), device='cpu', mesh=mesh)
    with pytest.raises(RuntimeError, match='process group'):
        RawData(c, device='cpu', mesh=mesh)
