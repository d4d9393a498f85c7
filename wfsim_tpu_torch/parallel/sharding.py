"""Multi-device runs over ``torch.distributed`` (counterpart of
wfsim_tpu/parallel/sharding.py; the reference has no parallelism of any
kind, SURVEY s2.4).

The physics is embarrassingly parallel in events (photons never interact)
and the digitizer grid in channels, except for the bottom-array sum, so
the mesh is a ``DeviceMesh`` with dims ``('events', 'channels')``
(:func:`make_mesh`).  It is built over a process group the caller has
initialised: the port never picks a backend.  NCCL serves one card per
rank; gloo serves ranks that share a card, or the CPU.  Every collective
here is a ``broadcast`` or an ``all_reduce`` of a device tensor, the two
that gloo also takes on CUDA tensors, so one code path serves both.  Host
objects travel by ``broadcast_object_list`` over a gloo group.  Every
group is made with the timeout the caller gave ``init_process_group``,
so a rank that dies fails the others instead of hanging them.

Two users of the mesh:

- :func:`make_sharded_step`, the explicit step (K14): each rank simulates
  the instruction blocks of its ``'events'`` index, digitizes its channel
  block with the ``superpose_block`` kernel, and the bottom-array partial
  sums meet in an ``all_reduce`` over ``'channels'``, the truth totals in
  one over ``'events'`` (wfsim_tpu's two ``psum``s);
- :class:`EventsComm`, the collectives of ``RawData(mesh=...)``: owned
  batches are broadcast from their owner, so every rank holds what the
  single-device run holds (see ``pipeline/rawdata.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.s1 import simulate_s1
from ..models.s2 import simulate_s2
from ..ops.waveform import superpose_block

__all__ = ['make_mesh', 'make_sharded_step', 'ShardedStep', 'EventsComm',
           'block_photons', 'simulate_block', 'seeded_generator',
           'MESH_DIMS']

MESH_DIMS = ('events', 'channels')


def _require_group(what):
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f'{what} needs a process group: call torch.distributed.'
            f'init_process_group first (NCCL with one card per rank, gloo '
            f'for ranks that share a card or on the CPU)')


def group_timeout(device_type: str):
    """The timeout the caller gave ``init_process_group`` (the default
    group's, on its backend for ``device_type``)."""
    pg = dist.distributed_c10d._get_default_group()
    return pg._get_backend(torch.device(device_type)).options._timeout


def make_mesh(n_events_axis: int | None = None, n_channel_axis: int = 1, *,
              device_type: str = 'cuda'):
    """An ``('events', 'channels')`` DeviceMesh over every rank of the
    initialised process group, ``n_events_axis`` x ``n_channel_axis``
    (default: every rank on ``'events'``); rank r sits at
    ``(r // n_channel_axis, r % n_channel_axis)``.  Its groups carry the
    default group's timeout.  Every rank calls it, in the same order."""
    from torch.distributed.device_mesh import DeviceMesh
    _require_group('make_mesh')
    world = dist.get_world_size()
    if n_events_axis is None:
        n_events_axis = world // n_channel_axis
    if (n_events_axis < 1 or n_channel_axis < 1
            or n_events_axis * n_channel_axis != world):
        raise ValueError(f'{n_events_axis} x {n_channel_axis} != {world} '
                         f'ranks')
    ranks = torch.arange(world).reshape(n_events_axis, n_channel_axis)
    timeout = group_timeout(device_type)
    me = dist.get_rank()
    mine = []
    # 'events' groups are the mesh's columns, 'channels' groups its rows
    for dim_ranks in (ranks.T, ranks):
        for group_ranks in dim_ranks.tolist():
            g = dist.new_group(group_ranks, timeout=timeout)
            if me in group_ranks:
                mine.append(g)
    return DeviceMesh.from_group(mine, device_type, ranks,
                                 mesh_dim_names=MESH_DIMS)


def _dim_size(mesh, name):
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def seeded_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator seeded from ``(seed, index)`` (numpy's SeedSequence):
    the port's ``fold_in(key, index)``, so draws depend on the index and
    not on the device or the rank that makes them."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


# ---------------------------------------------------------------------------
# the explicit step (K14)


def _field(inst, name, n, default):
    if isinstance(inst, dict):
        return np.asarray(inst[name]) if name in inst else np.full(n, default)
    return inst[name] if name in inst.dtype.names else np.full(n, default)


def simulate_block(params, const, inst, gen):
    """The photons of one instruction block: its S1 instructions (type 1),
    then its S2s (type 2), each chain as one batch with the generator
    ``gen``, one truth row per instruction.

    :param inst: structured instruction array or dict of arrays with time
        (ns from the grid's start, int32 range), x, y, z, amp, recoil,
        type and optional valid, local_field, e_dep
    :returns: (photons dict of t, ch, gain, valid concatenated S1 then S2,
        totals (2,) int64 ``[n_photon, n_pe]``)
    """
    dev = params.templates.device
    n = len(inst['time'])
    valid = _field(inst, 'valid', n, True).astype(bool)
    typ = np.asarray(inst['type'])
    time = np.asarray(inst['time']).astype(np.int64)
    if n and not (-2 ** 31 <= time.min() and time.max() < 2 ** 31):
        raise ValueError('step instruction times must fit int32 (ns from '
                         'the grid start)')
    parts, totals = [], torch.zeros(2, dtype=torch.int64, device=dev)
    for t_code, sim in ((1, simulate_s1), (2, simulate_s2)):
        m = np.flatnonzero(valid & (typ == t_code))
        if not len(m):
            continue
        f32 = {k: torch.as_tensor(_field(inst, k, n, 0.0)[m].astype(
            np.float32), device=dev)
            for k in ('x', 'y', 'z', 'local_field', 'e_dep')}
        x = dict(f32, time=torch.as_tensor(time[m].astype(np.int32),
                                           device=dev),
                 amp=torch.as_tensor(np.asarray(inst['amp'])[m].astype(
                     np.int32), device=dev),
                 recoil=torch.as_tensor(np.asarray(inst['recoil'])[m].astype(
                     np.int32), device=dev),
                 truth_row=torch.arange(len(m), dtype=torch.int64,
                                        device=dev))
        ph, truth, _req = sim(params, const, x, gen, n_truth_rows=len(m))
        parts.append(ph)
        totals += torch.stack([truth['n_photon'].sum(),
                               truth['n_pe'].sum()]).to(torch.int64)
    cat = {k: (torch.cat([p[k] for p in parts]) if parts else
               torch.zeros(0, dtype=dtype, device=dev))
           for k, dtype in (('t', torch.int32), ('ch', torch.int32),
                            ('gain', torch.float32), ('valid', torch.bool))}
    return cat, totals


def block_photons(photons, block, *, n_blocks: int, ch_block: int,
                  n_channels: int, n_samples: int, sample_duration: int):
    """The superposition inputs of channel block ``[ch_block, ch_block +
    n_channels)`` of one or more instruction blocks: the valid photons of
    those channels that start inside the grid (``0 <= t // dt <
    n_samples``, wfsim_tpu's ``photons_to_waveform`` drops the others),
    sorted stably by row ``block * n_channels + (ch - ch_block)``.

    :param photons: dict of t, ch, gain, valid (one instruction block's
        photons, or several concatenated)
    :param block: (N,) int64 instruction-block index of each photon, in
        ``[0, n_blocks)``
    :returns: dict of t, gain (row order, photon order within a row) and
        row_ptr ((n_blocks * n_channels + 1,) int32)
    """
    t, ch = photons['t'], photons['ch']
    dev = t.device
    n_rows = n_blocks * n_channels
    keep = (photons['valid'] & (ch >= ch_block)
            & (ch < ch_block + n_channels) & (t >= 0)
            & (t < n_samples * sample_duration))
    rows = block[keep] * n_channels + (ch[keep] - ch_block).to(torch.int64)
    rows, order = torch.sort(rows, stable=True)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_rows),
                               dim=0).to(torch.int32)
    return dict(t=t[keep][order].contiguous(),
                gain=photons['gain'][keep][order].contiguous(),
                row_ptr=row_ptr)


class ShardedStep:
    """The multi-device step of :func:`make_sharded_step`; call it as
    ``step(params, inst, seed)``.

    ``all_reduces`` lists ``(mesh dim, bytes)`` of every ``all_reduce`` it
    issued, in order: the counterpart of wfsim_tpu's compiled-HLO audit
    (only the sum row and the totals cross devices)."""

    def __init__(self, const, mesh, *, inst_per_shard: int, n_samples: int):
        self.const = const
        self.inst_per_shard = int(inst_per_shard)
        self.n_samples = int(n_samples)
        self.n_ev = _dim_size(mesh, 'events')
        self.n_ch = _dim_size(mesh, 'channels')
        C = int(const.n_tpc_pmts)
        C_pad = -(-C // self.n_ch) * self.n_ch          # sharding.py:68-70
        self.C_loc = C_pad // self.n_ch
        self.ev_index = mesh.get_local_rank('events')
        self.ch_block = mesh.get_local_rank('channels') * self.C_loc
        self.groups = {d: mesh.get_group(d) for d in MESH_DIMS}
        self.all_reduces: list = []

    def _all_reduce(self, x, dim):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.groups[dim])
        self.all_reduces.append((dim, x.numel() * x.element_size()))

    def __call__(self, params, inst, seed: int):
        """One step on this rank.

        :param inst: structured instruction array or dict (see
            :func:`simulate_block`) of ``n_blocks * inst_per_shard``
            instructions, ``n_blocks`` a multiple of the ``'events'`` dim
            (wfsim_tpu: equal to it); times in ns from the grid's start
        :param seed: block b draws from ``seeded_generator(seed, b)``
            (wfsim_tpu splits its key once per events shard), so a block's
            photons do not depend on the mesh, and the channel shards of
            one events index draw the same photons
        :returns: ``(adc, sum_signal, totals)``: adc ``(B, C_loc,
            n_samples)`` int32 of this rank's B = n_blocks / n_ev blocks and
            its channel block, sum_signal ``(B, n_samples)`` int32 (the
            bottom-array sum over every channel shard), totals ``(2,)``
            int64 ``[n_photon, n_pe]`` over every block of the mesh
        """
        const, T, ips = self.const, self.n_samples, self.inst_per_shard
        n = len(inst['time'])
        n_blocks = n // ips
        if n_blocks * ips != n or n_blocks % self.n_ev or not n_blocks:
            raise ValueError(f'{n} instructions are not a multiple of '
                             f'{self.n_ev} blocks of {ips}')
        B = n_blocks // self.n_ev
        first = self.ev_index * B
        dev = params.templates.device
        parts, totals = [], torch.zeros(2, dtype=torch.int64, device=dev)
        for b in range(B):
            sel = slice((first + b) * ips, (first + b + 1) * ips)
            blk = ({k: np.asarray(v)[sel] for k, v in inst.items()}
                   if isinstance(inst, dict) else inst[sel])
            ph, tot = simulate_block(
                params, const, blk, seeded_generator(seed, first + b, dev))
            ph['block'] = torch.full_like(ph['t'], b, dtype=torch.int64)
            parts.append(ph)
            totals += tot
        photons = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        ph = block_photons(photons, photons['block'], n_blocks=B,
                           ch_block=self.ch_block, n_channels=self.C_loc,
                           n_samples=T, sample_duration=const.sample_duration)
        adc, local_sum = superpose_block(
            ph['t'], ph['gain'], ph['row_ptr'], params.templates,
            n_channels=self.C_loc, ch_block=self.ch_block,
            n_top=const.n_top_pmts, n_tpc=const.n_tpc_pmts,
            current_2_adc=const.current_2_adc, n_samples=T)
        # the bottom-array sum needs every channel block: the one physics
        # collective (sharding.py:112-118); then the truth totals
        # (:120-125)
        self._all_reduce(local_sum, 'channels')
        self._all_reduce(totals, 'events')
        return adc.reshape(B, self.C_loc, T), local_sum, totals


def make_sharded_step(params, const, mesh, *, inst_per_shard: int = 8,
                      n_samples: int = 1024) -> ShardedStep:
    """The multi-device step of simulate -> digitize (wfsim_tpu
    sharding.py:54-133): a :class:`ShardedStep`, called as ``run(params,
    inst, seed)`` on every rank of ``mesh``.  ``params`` is taken at the
    call; wfsim_tpu's ``photon_capacity`` / ``electron_capacity`` fall away
    (eager torch knows every count)."""
    del params
    return ShardedStep(const, mesh, inst_per_shard=inst_per_shard,
                       n_samples=n_samples)


# ---------------------------------------------------------------------------
# the pipeline's collectives


def _check_events_mesh(mesh, device):
    """Raise unless ``mesh`` can carry ``RawData``: a process group exists,
    the mesh has an ``'events'`` dim, every other dim has size 1 (the
    pipeline shards events only, as wfsim_tpu's does) and its device type
    is ``device``'s."""
    _require_group('RawData(mesh=...)')
    names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
    if 'events' not in names:
        raise ValueError(f'the mesh has no "events" dim (dims {names})')
    for name in names:
        if name != 'events' and _dim_size(mesh, name) > 1:
            raise ValueError(
                f'the pipeline shards events only: mesh dim {name!r} has '
                f'size {_dim_size(mesh, name)} (make_sharded_step takes '
                f'channel blocks)')
    if mesh.device_type != device.type:
        raise ValueError(f'a {mesh.device_type} mesh for tensors on '
                         f'{device}')


class EventsComm:
    """The collectives of ``RawData(mesh=...)`` over the mesh's
    ``'events'`` dim: item ``i`` (a simulation or a digitize batch) belongs
    to rank ``i % size``; its owner broadcasts the host results and the
    device tensors, and every rank ends with the same.  ``diag`` (a
    ``Timers``) counts the device bytes broadcast as ``broadcast_bytes``."""

    def __init__(self, mesh, device, diag):
        _check_events_mesh(mesh, device)
        self.device = device
        self.diag = diag
        self.group = mesh.get_group('events')
        self.rank = mesh.get_local_rank('events')
        self.size = _dim_size(mesh, 'events')
        if dist.get_backend(self.group) == 'gloo':
            self.host_group = self.group
        else:
            self.host_group = dist.new_group(
                dist.get_process_group_ranks(self.group), backend='gloo',
                timeout=group_timeout(mesh.device_type))

    def owner(self, i: int) -> int:
        return i % self.size

    def _src(self, owner):
        return dist.get_global_rank(self.group, owner)

    def broadcast_object(self, obj, owner: int):
        """``obj`` of the owner (picklable host data) on every rank."""
        box = [obj if self.rank == owner else None]
        dist.broadcast_object_list(box, src=self._src(owner),
                                   group=self.host_group)
        return box[0]

    def broadcast_tensor(self, x, shape, dtype, owner: int):
        """The owner's contiguous device tensor ``x`` of ``shape`` and
        ``dtype`` on every rank (others pass None)."""
        if self.rank != owner:
            x = torch.empty(shape, dtype=dtype, device=self.device)
        if x.numel():
            dist.broadcast(x, src=self._src(owner), group=self.group)
            self.diag.add('broadcast_bytes', x.numel() * x.element_size())
        return x

    def all_reduce(self, x, op):
        dist.all_reduce(x, op=op, group=self.group)
        return x
