"""The metric readers and the trace arithmetic."""
import pytest

from bench_port import harness, tracing


def ctx(**kw):
    base = dict(events=2000, timed_events=2000, window_s=10.0, setup_s=12.5,
                peak_bytes=2 ** 31,
                timers=dict(chunker_final=1.0, digitize_plan=0.5,
                            simulate_s2=0.25, pmt_afterpulses=0.25,
                            digitize_batches=0.1,
                            digitize_host_records=0.2),
                trace=dict(busy_s=0.5, window_s=2.0, kernels={}),
                roofline={'superpose': (0.001, 0.004, 3)})
    base.update(kw)
    return base


@pytest.mark.parametrize('name, value', [
    ('events_per_s', 200.0),
    ('peak_device_gib', 2.0),
    ('setup_s', 12.5),
    ('chunker.ms_per_kevent', 500.0),
    ('orchestration.plan_ms_per_kevent', 250.0),
    ('physics.ms_per_kevent', 250.0),
    ('digitize.ms_per_kevent', 50.0),
    ('collection.ms_per_kevent', 100.0),
    ('device.idle_pct', 75.0),
    ('superpose.roofline_pct', 25.0),
])
def test_reader_values(name, value):
    assert harness.reader(name)(ctx()) == pytest.approx(value)


@pytest.mark.parametrize('name', ['device.idle_pct', 'superpose.roofline_pct',
                                  'pmt_afterpulse.roofline_pct'])
def test_readers_with_nothing_to_read_return_none(name):
    assert harness.reader(name)(ctx(trace=None, roofline={})) is None


def test_busy_union():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    union = tracing.merged(iv)
    assert union == [[0, 3], [5, 6], [10, 10]]
    assert sum(b - a for a, b in union) == 4


def test_bound():
    assert tracing.bound_s(3.35e12) == pytest.approx(1.0)
    assert tracing.bound_s(0, 67e12) == pytest.approx(1.0)
    assert tracing.bound_s(0, 0, 34e12) == pytest.approx(1.0)
