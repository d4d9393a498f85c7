"""Rank processes for tests/test_torch_sharding.py: gloo on the CPU, one
process per rank, started with ``spawn`` and joined with a time limit.

Kept apart from the test module so that a rank imports torch and
wfsim_tpu_torch only (no JAX)."""
import contextlib
import datetime
import multiprocessing as mp
import pickle
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: a rank's collectives fail after this long instead of hanging
COLLECTIVE_TIMEOUT_S = 60


def run_ranks(target, world, tmp_path, *args, meanwhile=None,
              limit_s=120):
    """Run ``target(rank, world, *args)`` in ``world`` gloo processes and
    return (each rank's result, ``meanwhile()``): ``meanwhile`` (if given)
    runs in this process while the ranks do.  Fails on a non-zero exit of
    any rank, or when the ranks are not done within ``limit_s`` of their
    start (they are killed)."""
    ctx = mp.get_context('spawn')
    tmp = Path(tmp_path)
    tag = f'{target.__name__}_{world}'
    init = tmp / f'{tag}_init'
    procs = [ctx.Process(target=_rank_main,
                         args=(target, rank, world, str(init), str(tmp),
                               args))
             for rank in range(world)]
    deadline = time.monotonic() + limit_s
    try:
        for p in procs:
            p.start()
        here = meanwhile() if meanwhile is not None else None
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join(10)
    assert not late, f'{len(late)} of {world} ranks ran past {limit_s} s'
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f'rank exit codes {codes}'
    out = []
    for rank in range(world):
        with open(tmp / f'{tag}_rank{rank}.pkl', 'rb') as f:
            out.append(pickle.load(f))
    return out, here


def _rank_main(target, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method='file://' + init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = target(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f'{target.__name__}_{world}_rank{rank}.pkl',
              'wb') as f:
        pickle.dump(result, f)


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A gloo process group of this process alone, destroyed on exit."""
    dist.init_process_group(
        'gloo', init_method='file://' + str(Path(tmp_path) / 'one_rank_init'),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def setup(config):
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.resources import load_config
    return build_params(config, load_config(config), 'cpu'), \
        build_constants(config)


def run_step(config, inst, n_ev, n_ch, *, inst_per_shard, n_samples, seed):
    """One step on a fresh ``n_ev`` x ``n_ch`` mesh of the CPU ranks."""
    from wfsim_tpu_torch.parallel import make_mesh, make_sharded_step
    params, const = setup(config)
    mesh = make_mesh(n_ev, n_ch, device_type='cpu')
    step = make_sharded_step(params, const, mesh,
                             inst_per_shard=inst_per_shard,
                             n_samples=n_samples)
    adc, sum_signal, totals = step(params, inst, seed)
    return dict(adc=adc.numpy(), sum_signal=sum_signal.numpy(),
                totals=totals.numpy(), all_reduces=step.all_reduces,
                events_index=mesh.get_local_rank('events'),
                channel_index=mesh.get_local_rank('channels')), mesh


def mesh_rank(rank, world, step_config, step_inst, shapes, step_kw,
              sim_configs, sim_inst):
    """The step at each ``(n_ev, n_ch)`` of ``shapes`` (with channel
    shards, also whether ``RawData`` refuses the mesh: the pipeline
    shards events only), then ``Simulator(config, mesh=make_mesh(world,
    1))`` on ``sim_inst`` for each of ``sim_configs`` (name -> config)."""
    from wfsim_tpu_torch import RawData, Simulator
    from wfsim_tpu_torch.parallel import make_mesh
    res = dict(steps={}, sims={})
    for n_ev, n_ch in shapes:
        out, mesh = run_step(step_config, step_inst, n_ev, n_ch, **step_kw)
        out['pipeline_refused'] = None
        if n_ch > 1:
            try:
                RawData(step_config, device='cpu', mesh=mesh)
            except ValueError as e:
                out['pipeline_refused'] = str(e)
        res['steps'][n_ev, n_ch] = out
    for name, config in sim_configs.items():
        sim = Simulator(config, device='cpu',
                        mesh=make_mesh(world, 1, device_type='cpu'))
        res['sims'][name] = dict(out=sim.get_arrays(sim_inst),
                                 diag=sim.sim.rawdata.diag.summary())
    return res
