"""The traffic mixes: instruction streams from the seed."""
import numpy as np
import pytest

from bench_port import traffic

MIXES = ['gamma_0.1_1mev', 'er_1_100kev']
GEO = dict(tpc_radius=50.0, tpc_length=97.0, drift_field=82.0)


@pytest.mark.parametrize('name', MIXES)
def test_stream_repeats_from_the_seed(name):
    mix = traffic.load_mix(name)
    a = traffic.instructions(mix, 2 ** 31 + 12345, **GEO, n_events=3000)
    b = traffic.instructions(mix, 2 ** 31 + 12345, **GEO, n_events=3000)
    c = traffic.instructions(mix, 2 ** 31 + 12346, **GEO, n_events=3000)
    assert a.tobytes() == b.tobytes()
    assert a.tobytes() != c.tobytes()


@pytest.mark.parametrize('name', MIXES)
def test_stream_follows_the_mix(name):
    mix = traffic.load_mix(name)
    n = 2048
    inst = traffic.instructions(mix, 99, **GEO, n_events=n)
    assert len(inst) == 2 * n
    assert (inst['type'][0::2] == 1).all() and (inst['type'][1::2] == 2).all()
    lo, hi = mix['energy_kev']
    e = inst['e_dep'][0::2].astype(np.float64)
    assert e.min() >= lo and e.max() <= hi
    assert set(np.unique(inst['recoil'])) <= set(mix['recoil_types'])
    # evenly spread at the mix's rate, S1 and S2 of an event together
    dt = np.diff(inst['time'][0::2])
    assert abs(np.median(dt) - 1e9 / mix['event_rate_hz']) <= 1
    assert (inst['time'][0::2] == inst['time'][1::2]).all()
    # the quanta rule
    q = mix['quanta']
    total = np.floor(inst['e_dep'][0::2].astype(np.float64) / q['w_kev'])
    electrons = np.floor(total * q['electron_fraction'])
    assert np.allclose(inst['amp'][1::2], electrons, atol=1)
    assert np.allclose(inst['amp'][0::2] + inst['amp'][1::2], total, atol=1)
    # inside the TPC
    r = np.hypot(inst['x'], inst['y'])
    assert (r <= GEO['tpc_radius'] + 1e-3).all()
    assert ((inst['z'] <= 0) & (inst['z'] >= -GEO['tpc_length'])).all()


@pytest.mark.parametrize('name', MIXES)
def test_every_block_carries_the_same_events(name):
    mix = traffic.load_mix(name)
    block = mix['stratified_block']
    a = traffic.instructions(mix, 1, **GEO, n_events=2 * block)
    b = traffic.instructions(mix, 2, **GEO, n_events=2 * block)
    for k in range(2):
        sl = slice(2 * k * block, 2 * (k + 1) * block)
        for field in ('amp', 'z'):
            assert np.array_equal(np.sort(a[field][sl]),
                                  np.sort(b[field][sl]))
        assert not np.array_equal(a['amp'][sl], b['amp'][sl])


def test_quanta_rule():
    ph, el = traffic.quanta(np.array([1.0, 13.7e-3 * 101.5, 1000.0]),
                            dict(w_kev=13.7e-3, electron_fraction=0.5))
    assert list(el) == [36, 50, 36496]
    assert list(ph + el) == [72, 101, 72992]


def test_unknown_mix_raises():
    with pytest.raises(FileNotFoundError):
        traffic.load_mix('no_such_mix')
