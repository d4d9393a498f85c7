"""chip_smoke.py's device-time cut on the CPU: ``named_calls`` keeps only
the records named after the measured entry and refuses a session where
the profiler dropped or added one of them; ``below_bound`` refuses a
device time below the row's bound; ``bounded_device_ms`` takes such a
session again before it refuses; ``busy_union``, the device's busy time
of ``device_busy``, counts overlapping records once.  The records are
made up here (the profiler runs only on the card)."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KERNEL, MEMSET, COPY, FILL = ('superpose_block_kernel<10, 22>',
                              'Memset (Device)',
                              'Memcpy DtoH (Device -> Pinned)',
                              'vectorized_elementwise_kernel<FillFunctor>')
NAMES = ('superpose_block_kernel', 'Memset', 'Memcpy DtoH')
REPS = 5


def session(reps=REPS, fills=8):
    """Records of ``fills`` fills, then ``reps`` calls of memset, kernel
    and status copy (call i's kernel takes 50 + i us)."""
    recs = [(FILL, 1.0)] * fills
    for i in range(reps):
        recs += [(MEMSET, 1.0), (KERNEL, 50.0 + i), (COPY, 2.5)]
    return recs


def test_named_calls_cut_whole_calls(smoke):
    calls = smoke.named_calls(session(), REPS, NAMES)
    assert len(calls) == REPS
    assert all([n for n, _us in c] == [MEMSET, KERNEL, COPY] for c in calls)
    assert [c[1][1] for c in calls] == [50.0 + i for i in range(REPS)]


@pytest.mark.parametrize('fault', ['dropped_kernel', 'dropped_first',
                                   'added_kernel', 'swapped', 'none_kept'])
def test_named_calls_refuse_broken_sessions(smoke, fault):
    """A record of the entry missing or added anywhere, or two calls in
    another order, gives [] ("not measured"), not a wrong time."""
    recs = session()
    if fault == 'dropped_kernel':
        del recs[8 + 3 * 2 + 1]
    elif fault == 'dropped_first':
        recs = session(fills=0)[1:]
    elif fault == 'added_kernel':
        recs.insert(12, (KERNEL, 3.0))
    elif fault == 'swapped':
        i = 8 + 3 * 3
        recs[i], recs[i + 1] = recs[i + 1], recs[i]
    else:
        recs = [(FILL, 1.0)] * 15
    assert smoke.named_calls(recs, REPS, NAMES) == []


def test_named_calls_ignore_other_records(smoke):
    """Fills and other kernels between the calls do not change the cut
    (the old cut guessed ceil(records / reps) records a call)."""
    recs = session()
    for i in (30, 21, 14, 9):
        recs.insert(i, ('reduce_kernel<other>', 4.0))
    calls = smoke.named_calls(recs, REPS, NAMES)
    assert [sum(us for _n, us in c) for c in calls] == \
        [53.5 + i for i in range(REPS)]


def test_below_bound(smoke):
    smoke.below_bound('row', None, 0.04)
    smoke.below_bound('row', 0.0554, 0.038972)
    with pytest.raises(AssertionError, match='below its bound'):
        smoke.below_bound('row', 0.0051, 0.009159)


@pytest.mark.parametrize('times,want', [
    ((0.0554,), 0.0554),                 # the first session holds
    ((0.0038, 0.0554), 0.0554),          # a session below the bound again
    ((None, None, 0.0554), 0.0554),      # sessions without a time again
    ((None, None, None), None),          # never a time: not measured
    ((0.0038, None, 0.0038), 'raises'),  # only times below the bound
])
def test_bounded_device_ms_takes_a_session_again(smoke, monkeypatch, times,
                                                 want):
    """A profiler session that gives no time, or one below the row's
    bound, is taken again (up to three sessions), cold (the L2 flushed)
    from the first time below the bound on; only times below the bound
    raise."""
    left = list(times)
    colds = []

    def fake(fn, names=None, cold=False):
        colds.append(cold)
        return left.pop(0), {}
    monkeypatch.setattr(smoke, 'device_ms', fake)
    if want == 'raises':
        with pytest.raises(AssertionError, match='below its bound'):
            smoke.bounded_device_ms('row', None, NAMES, 0.005628)
    else:
        assert smoke.bounded_device_ms('row', None, NAMES,
                                       0.005628)[0] == want
    low = [t is not None and t < 0.005628 for t in times[:len(colds)]]
    assert colds == [any(low[:i]) for i in range(len(colds))]


def test_cold_session_needs_names(smoke):
    """A cold session's flush is left out only by a names filter."""
    with pytest.raises(ValueError, match='needs names'):
        smoke.device_ms(lambda: None, cold=True)


@pytest.mark.parametrize('intervals,want', [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 12), (20, 25)], 17.0),     # overlap counted once
    ([(20, 25), (0, 10), (2, 3)], 15.0),      # unsorted, nested
    ([(0, 10), (10, 12)], 12.0),              # touching
])
def test_busy_union(smoke, intervals, want):
    assert smoke.busy_union(iter(intervals)) == want
