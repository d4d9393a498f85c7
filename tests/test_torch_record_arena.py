"""The record collection of wfsim_tpu_torch's ``RawData`` on the CPU: each
digitize round's records sorted and written as strax raw_record rows on
the device (``pipeline.digitize.round_records``; its kernel K4r,
``record_rows``, runs its plain twin here), one copy a round into the
host record arena (``pipeline/arena.py``), and round k collected after
super-batch k+1 is dispatched (``RawData.iter_windows``).

wfsim_tpu's rule (``_collect_digitize_work``, pipeline/rawdata.py:1785-1818:
one ``np.lexsort((C, S, W))`` a round, every record written into its
sorted slot, the windows' records split by window) is restated in numpy
(``lexsort_records``) from ``pack_records_ref``'s outputs.

Tolerances, per quantity:

- a fixed pulse set (``tests/test_torch_streaming.py``'s) digitized in 1
  to 4 rounds: every window's records byte for byte the restated rule's,
  the window framing equal to wfsim_tpu's;
- ``round_records`` on cases with skewed windows against the restated
  rule: rows byte for byte, per-window counts equal;
- the chunk of a run over four rounds: a view of one arena base;
- a depth-4 run with noise, PMT and electron afterpulses: sha256 of its
  ``raw_records`` and ``truth`` bytes equal to those taken on commit
  ``bf8024d``, before the arena;
- the order of a run's truth hand-overs and window yields, and records
  and truth of chunks cut inside rounds: exact.

The cases are numpy only, made from a seed (``row_case``), so that
tests/test_torch_cuda.py can import them on the card's machine, which has
no JAX: JAX is imported inside the tests that use it.
"""
import hashlib

import numpy as np
import pytest
import torch

from wfsim_tpu_torch import ChunkRawRecords, RawData, Simulator
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.dtypes import raw_record_dtype
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.pipeline.arena import RecordArena
from wfsim_tpu_torch.pipeline.digitize import (
    gather_digitize, pack_records_ref, record_rows, record_rows_ref,
    round_records)
from wfsim_tpu_torch.pipeline.rawdata import _Pulse

DT = 10

#: the depth-4 noisy run (NOISY_CONFIG on 20 bench events, 4 super-batches):
#: sha256 of its raw_records and truth bytes, taken on commit bf8024d (the
#: collection by ``RawData._host_records``, before the record arena)
NOISY_CONFIG = dict(seed=99, chunk_size=1000, pipeline_depth=4,
                    pipeline_min_batch=8, enable_noise=True,
                    enable_pmt_afterpulses=True,
                    enable_electron_afterpulses=True)
NOISY_DIGESTS = dict(
    raw_records=(33847, 'ef5b48db749615055e610de43b84b15d1b03a8503540c4056'
                        '2948ce9e85e3fa3'),
    truth=(57, '5abdd92f1896342068dfe661b223d428cb9efe3129e37873b5f040bf9'
               '5a06e91'))
#: the runs without noise: 20 bench events in 4 super-batches
RUN_CONFIG = dict(seed=99, pipeline_depth=4, pipeline_min_batch=8)
RUN_EVENTS = 20


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread while this module runs: its CPU runs are many
    small ops, which the test runner's parallel workers slow down many
    times over when each op spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lexsort_records(parts, win_left, dt=DT):
    """wfsim_tpu's record collection restated in numpy: the records of
    ``parts`` (per batch: its windows' round indices, rec_data (n, 110)
    int16, rec_meta (n, 6) int32 ``[w, c, start, length, pulse_length,
    record_i]``) in ``np.lexsort((C, S, W))`` order as a raw_record array,
    and the bounds of each window's slice."""
    W = np.concatenate([np.asarray(b, np.int64)[m[:, 0]]
                        for b, _, m in parts])
    meta = np.concatenate([m for _, _, m in parts])
    data = np.concatenate([d for _, d, _ in parts])
    order = np.lexsort((meta[:, 1], meta[:, 2], W))
    W, meta, data = W[order], meta[order], data[order]
    recs = np.zeros(len(W), raw_record_dtype(110))
    recs['time'] = (np.asarray(win_left, np.int64)[W]
                    + meta[:, 2].astype(np.int64)) * dt
    recs['length'] = meta[:, 3]
    recs['dt'] = dt
    recs['channel'] = meta[:, 1]
    recs['pulse_length'] = meta[:, 4]
    recs['record_i'] = meta[:, 5]
    recs['data'] = data
    return recs, np.searchsorted(W, np.arange(len(win_left) + 1))


# ---------------------------------------------------------------------------
# a fixed pulse set digitized in rounds


#: tests/test_torch_streaming.py's pulse starts (ns), restated without
#: that module's JAX import (test_pulse_set_is_the_streaming_one)
PULSE_STARTS = (0, 35_000, 400_000, 3_000_000, 3_060_000, 9_000_000,
                9_150_000, 9_190_000)


def photon_buffers(seed=11):
    """tests/test_torch_streaming.py's photon buffers: one (t, ch, gain)
    set of numpy arrays a pulse, times relative to its start."""
    rng = np.random.default_rng(seed)
    out = []
    for k, _ in enumerate(PULSE_STARTS):
        n = 200 + 50 * k
        out.append((np.sort(rng.integers(0, 20_000, n)).astype(np.int32),
                    rng.integers(0, 64, n).astype(np.int32),
                    rng.uniform(1e6, 3e6, n).astype(np.float32)))
    return out


@pytest.fixture(scope='module')
def pulse_set():
    return PULSE_STARTS, photon_buffers()


def test_pulse_set_is_the_streaming_one(pulse_set):
    from . import test_torch_streaming as ts
    assert ts.PULSE_STARTS == PULSE_STARTS
    for a, b in zip(ts.photon_buffers(11), pulse_set[1]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def digitized_rounds(pulse_set, splits, device='cpu'):
    """The pulse set digitized in rounds, one per ``safe_t`` in ``splits``
    (each adds the pulses that start before it), as
    ``port_round_windows`` in tests/test_torch_streaming.py does: per
    round its plan (``plan_digitize``'s windows, photon arena and
    batches), windows and window records; and the RawData."""
    starts, bufs = pulse_set
    rd = RawData(dict(default_config(), seed=7), device=device)
    plans = []
    plan = rd.plan_digitize

    def spy(safe_t=np.inf):
        plans.append(plan(safe_t))
        return plans[-1]
    rd.plan_digitize = spy
    rounds = []
    added = 0
    for safe_t in splits:
        while added < len(starts) and starts[added] < safe_t:
            t, ch, g = bufs[added]
            bid = rd._add_buffer({k: torch.as_tensor(v, device=device)
                                  for k, v in zip(('t', 'ch', 'gain'),
                                                  (t, ch, g))})
            rd._pulses.append(_Pulse(bid, 0, len(t), int(t[0]) + starts[added],
                                     int(t[-1]) + starts[added],
                                     starts[added]))
            added += 1
        wins, recs = rd._collect_round(rd._dispatch_digitize(safe_t))
        rounds.append((plans[-1] if wins else None, wins, recs))
    return rd, rounds


SPLITS = ([np.inf], [6_000_000, np.inf], [3_050_000, 9_100_000, np.inf],
          [100_000, 3_020_000, 9_180_000, np.inf])


@pytest.mark.parametrize('splits', SPLITS)
def test_rounds_follow_the_lexsort_rule(pulse_set, splits, monkeypatch):
    """Each round's window records, byte for byte the restated rule on
    the twins' pack_records outputs of its batches, one view of the arena
    a window; the framing of every round equal to wfsim_tpu's."""
    from .test_torch_streaming import jax_round_windows
    rd, rounds = digitized_rounds(pulse_set, splits)
    n_win = 0
    for plan, wins, recs in rounds:
        if plan is None:
            assert wins == [] and recs == []
            continue
        _wins, arena, batches = plan
        parts = []
        for batch, T_cap, pieces, nix in batches:
            g = gather_digitize(rd.params, rd.const, *arena,
                                torch.as_tensor(pieces), torch.as_tensor(nix),
                                n_samples=T_cap, max_intervals=64)
            parts.append((batch, *(x.numpy() for x in pack_records_ref(
                g['data'], g['left_all'], g['starts'], g['ends'],
                g['counts']))))
        ref, bounds = lexsort_records(parts, [w['win_left'] for w in wins])
        assert len(recs) == len(wins)
        for i, r in enumerate(recs):
            assert r.dtype == ref.dtype
            assert r.tobytes() == ref[bounds[i]:bounds[i + 1]].tobytes(), i
        bases = {id(r.base) for r in recs if len(r)}
        assert len(bases) == 1
        assert np.all(np.diff(np.concatenate(recs)['time']) >= 0)
        n_win += len(wins)
    assert n_win >= 4
    ours = [[(w['win_left'], w['win_right'], w['flush']) for w in wins]
            for _plan, wins, _recs in rounds]
    assert ours == jax_round_windows(splits, monkeypatch)


# ---------------------------------------------------------------------------
# round_records (K4r's twin and the sort) on skewed cases

ROW_CASES = (
    'bench-like batches',
    'one channel of many records',
    'empty windows and a batch without records',
    'no records',
)


def row_case(name):
    """One case of ``round_records``' inputs, numpy only: ``parts`` (per
    batch: its windows' round indices, then ``pack_records_ref``'s
    rec_data and rec_meta on a random grid with random ZLE intervals),
    ``win_left`` (W,) int64, ``n_samples`` and ``n_rows``.  Batches take
    windows in shuffled order (as T_cap buckets do)."""
    rng = np.random.default_rng(ROW_CASES.index(name) + 2100)
    n_win, C, T, K = 24, 16, 2048, 6
    if name == 'one channel of many records':
        T = 2 ** 16
    order = rng.permutation(n_win)
    batches = [np.sort(order[0:9]), np.sort(order[9:13]),
               np.sort(order[13:24])]
    win_left = (10 ** 11 + np.cumsum(rng.integers(T, 50 * T, n_win))
                ).astype(np.int64)
    empty = set()
    if name == 'empty windows and a batch without records':
        empty = set(batches[1].tolist()) | {int(order[0]), int(order[20])}
    parts = []
    for batch in batches:
        B = len(batch)
        data = rng.integers(-2 ** 15, 2 ** 15, (B, C, T)).astype(np.int16)
        left = rng.integers(0, 200, (B, C)).astype(np.int32)
        starts = np.zeros((B, C, K), np.int32)
        ends = np.zeros((B, C, K), np.int32)
        counts = np.zeros((B, C), np.int32)
        for bi, w in enumerate(batch):
            if name == 'no records' or int(w) in empty:
                continue
            for c in range(C):
                span = T - int(left[bi, c])
                if name == 'one channel of many records' and c != 3:
                    continue
                if name == 'one channel of many records' and bi == 0:
                    # one interval over the whole row: ~600 records
                    starts[bi, c, 0], ends[bi, c, 0] = 0, span - 1
                    counts[bi, c] = 1
                    continue
                n = int(rng.integers(0, K + 1))
                cuts = np.sort(rng.choice(span, 2 * n, replace=False))
                starts[bi, c, :n], ends[bi, c, :n] = cuts[0::2], cuts[1::2]
                counts[bi, c] = n
        rd, rm = pack_records_ref(*(torch.as_tensor(a) for a in
                                    (data, left, starts, ends, counts)))
        parts.append((batch, rd.numpy(), rm.numpy()))
    return dict(parts=parts, win_left=win_left, n_samples=T, n_rows=C)


def torch_parts(case, dev='cpu'):
    return [(b, torch.as_tensor(d, device=dev), torch.as_tensor(m, device=dev))
            for b, d, m in case['parts']]


@pytest.mark.parametrize('name', ROW_CASES)
def test_round_records_follow_the_lexsort_rule(name):
    case = row_case(name)
    ref, bounds = lexsort_records(case['parts'], case['win_left'])
    rows, counts = round_records(torch_parts(case), case['win_left'], dt=DT,
                                 n_samples=case['n_samples'],
                                 n_rows=case['n_rows'])
    assert rows.dtype == torch.int16 and tuple(rows.shape) == (len(ref), 122)
    assert rows.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(counts, np.diff(bounds))
    n = len(ref)
    if name == 'no records':
        assert n == 0
    if name == 'one channel of many records':
        assert counts.max() > 500 and np.unique(ref['channel']).size == 1
    if name == 'empty windows and a batch without records':
        assert (counts == 0).sum() >= 6 and n > 0
        assert len(case['parts'][1][1]) == 0


def test_record_rows_checks_and_order():
    """The wrapper takes exactly its dtypes and shapes; the twin's row i
    is record perm[i] whatever the permutation (here reversed)."""
    case = row_case('bench-like batches')
    data = torch.as_tensor(np.concatenate([d for _, d, _ in case['parts']]))
    meta = torch.as_tensor(np.concatenate([m for _, _, m in case['parts']]))
    win = torch.as_tensor(np.concatenate(
        [np.asarray(b, np.int32)[m[:, 0]] for b, _, m in case['parts']]))
    wl = torch.as_tensor(case['win_left'])
    n = data.shape[0]
    ident = record_rows(data, meta, win, wl, torch.arange(n), DT)
    rev = record_rows(data, meta, win, wl, torch.arange(n - 1, -1, -1), DT)
    assert torch.equal(rev, ident.flip(0))
    assert torch.equal(ident, record_rows_ref(data, meta, win, wl,
                                              torch.arange(n), DT))
    for bad in (dict(win=win.to(torch.int64)), dict(perm=torch.arange(n - 1)),
                dict(data=data.to(torch.int32))):
        kw = dict(data=data, meta=meta, win=win, win_left=wl,
                  perm=torch.arange(n))
        kw.update(bad)
        with pytest.raises((TypeError, ValueError)):
            record_rows(dt=DT, **kw)


def test_round_records_raise_where_keys_do_not_fit():
    case = row_case('bench-like batches')
    with pytest.raises(OverflowError):
        round_records(torch_parts(case), case['win_left'], dt=DT,
                      n_samples=2 ** 40, n_rows=2 ** 20)


# ---------------------------------------------------------------------------
# runs


def spied_run(c, inst):
    """A ChunkRawRecords run on the CPU: its chunks, the arena base of
    each window's records, the run's rounds, and the order of its truth
    hand-overs and window yields (``('truth' or 'window', super-batches
    simulated, rounds dispatched)``, runs of equal entries collapsed)."""
    chunker = ChunkRawRecords(c, device='cpu')
    rd = chunker.rawdata
    bases, events = [], []
    windows = rd.iter_windows

    def state(kind):
        return (kind, rd.diag.counts['super_batches'], rd.diag.counts['rounds'])

    def spy(*args, truth_buffer, **kwargs):
        def sink(rows):
            events.append(state('truth'))
            truth_buffer(rows)
        for w in windows(*args, truth_buffer=sink, **kwargs):
            events.append(state('window'))
            if len(w['records']):
                bases.append(w['records'].base)
            yield w
    rd.iter_windows = spy
    chunks = list(chunker(inst))
    order = [e for i, e in enumerate(events) if i == 0 or e != events[i - 1]]
    return dict(chunks=chunks, bases=bases, rounds=rd.diag.counts['rounds'],
                order=order)


@pytest.fixture(scope='module')
def two_runs():
    """The same run twice in one process, the record arena's high-water
    mark 0 before the first (so the first sizes the second's base)."""
    saved = RecordArena.chunk_rows
    RecordArena.chunk_rows = 0
    try:
        c = default_config(chunk_size=1000, **RUN_CONFIG)
        inst = bench_instructions(RUN_EVENTS)
        first = spied_run(c, inst)
        hw = RecordArena.chunk_rows
        return first, hw, spied_run(c, inst)
    finally:
        RecordArena.chunk_rows = saved


def test_chunk_over_rounds_is_a_view(two_runs):
    """With no chunk seen yet, each round takes a base of its own and the
    chunk is a copy; the next run's base holds the chunk's rows, so its
    four rounds lie in one base and the chunk is a view of it.  The bytes
    are the same."""
    first, hw, second = two_runs
    assert first['rounds'] == second['rounds'] == 4
    assert len(first['chunks']) == len(second['chunks']) == 1
    assert len({id(b) for b in first['bases']}) == 4
    rr = first['chunks'][0]['raw_records']
    assert hw == len(rr)
    assert not any(np.shares_memory(rr, b) for b in first['bases'])
    base = second['bases'][0]
    assert all(b is base for b in second['bases'])
    rr2 = second['chunks'][0]['raw_records']
    assert np.shares_memory(rr2, base) and rr2.base is base
    assert len(base) == len(rr2)
    assert rr2.tobytes() == rr.tobytes()
    assert second['chunks'][0]['truth'].tobytes() == \
        first['chunks'][0]['truth'].tobytes()


def test_one_round_deep(two_runs):
    """Super-batch k+1 is simulated and its round dispatched before round
    k's windows are yielded; super-batch k's truth is handed over after
    round k-1's windows and before round k's."""
    for run in two_runs[::2]:
        assert run['order'] == [
            ('truth', 1, 1), ('window', 2, 2), ('truth', 2, 2),
            ('window', 3, 3), ('truth', 3, 3), ('window', 4, 4),
            ('truth', 4, 4), ('window', 4, 4)]


def test_chunks_cut_inside_rounds(two_runs):
    """20 ms chunks over the 4 rounds (each round's records cut by the
    chunk boundaries) give the bytes of one chunk."""
    one = two_runs[2]['chunks'][0]
    sim = Simulator(default_config(chunk_size=0.02, **RUN_CONFIG),
                    device='cpu')
    chunks = list(sim.run(bench_instructions(RUN_EVENTS)))
    assert len(chunks) >= 3
    rr = np.concatenate([ch['raw_records'] for ch in chunks])
    assert rr.tobytes() == one['raw_records'].tobytes()
    truth = np.concatenate([ch['truth'] for ch in chunks])
    assert np.sort(truth, order='time').tobytes() == one['truth'].tobytes()


def test_depth4_noisy_run_matches_the_parent():
    sim = Simulator(default_config(**NOISY_CONFIG), device='cpu')
    out = sim.get_arrays(bench_instructions(20))
    assert sim.sim.rawdata.diag.counts['rounds'] == 4
    for key, (n, digest) in NOISY_DIGESTS.items():
        assert len(out[key]) == n, key
        assert hashlib.sha256(out[key].tobytes()).hexdigest() == digest, key
