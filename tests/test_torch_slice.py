"""The main path end to end on the CPU: ``Simulator(...).get_arrays`` of
wfsim_tpu_torch and of wfsim_tpu on 8 events of the bench workload
(XENONnT, 494 channels).

The two packages draw different random numbers by construction (torch
generators vs JAX threefry), so records cannot match one for one.  Checks,
with their tolerances: identical dtypes; one truth row per instruction;
records time-sorted and strax-valid; per-type mean photon counts and
per-event record counts agree within 5 sigma of the 8-event spread; the
summed record area tracks the truth raw area within 10 %; a rerun with the
same seed is bitwise identical.
"""
import numpy as np
import pytest

from bench import _make_inst
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.interface.simulator import Simulator as JaxSimulator

from wfsim_tpu_torch import Simulator, default_config
from wfsim_tpu_torch.interface import bench_instructions

N_EVENTS = 8
EVENT_SPACING = 4_000_000


@pytest.fixture(scope='module')
def runs():
    inst = bench_instructions(N_EVENTS, 2000, 300)
    cfg = default_config(seed=1234, chunk_size=100)
    ours = Simulator(cfg, device='cpu').get_arrays(inst)
    ref = JaxSimulator(jax_default_config(seed=1234, chunk_size=100)
                       ).get_arrays(_make_inst(N_EVENTS, 2000, 300))
    return inst, cfg, ours, ref


def test_bench_instructions_match_bench_recipe():
    a, b = bench_instructions(N_EVENTS, 2000, 300), _make_inst(N_EVENTS, 2000, 300)
    assert a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def test_slice_dtypes(runs):
    _, _, ours, ref = runs
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k


def test_slice_truth_rows(runs):
    inst, _, ours, ref = runs
    for out in (ours, ref):
        truth = out['truth']
        assert len(truth) == len(inst)
        assert (truth['type'] == 1).sum() == (truth['type'] == 2).sum() == N_EVENTS
        ok = truth['n_photon'] > 0
        assert np.all(truth['t_first_photon'][ok] <= truth['t_mean_photon'][ok])
        assert np.all(truth['t_mean_photon'][ok] <= truth['t_last_photon'][ok])
        assert np.all(truth['endtime'][ok] >= truth['t_last_photon'][ok])


def test_slice_records_strax_valid(runs):
    _, cfg, ours, _ = runs
    rr = ours['raw_records']
    assert len(rr) > 1000
    assert np.all(np.diff(rr['time']) >= 0)
    for ch in np.unique(rr['channel']):
        assert np.all(np.diff(rr['time'][rr['channel'] == ch]) >= 0), ch
    assert np.all(rr['dt'] == 10)
    assert rr['data'].min() >= 0 and rr['data'].max() <= 16000
    assert np.all((rr['channel'] >= 0) & (rr['channel'] < 494))
    assert np.all((rr['length'] > 0) & (rr['length'] <= 110))
    assert np.all(rr['pulse_length'] >= rr['length'])
    # record i of a pulse holds samples [110 i, 110 i + length)
    np.testing.assert_array_equal(
        rr['length'], np.minimum(110, rr['pulse_length']
                                 - 110 * rr['record_i'].astype(np.int64)))
    # zero tails past the record length
    j = np.arange(110)[None, :]
    assert np.all(rr['data'][j >= rr['length'][:, None]] == 0)
    for k in ('raw_records_he', 'raw_records_aqmon'):
        assert len(ours[k]) == 0


def _spread_check(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    sigma = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert abs(a.mean() - b.mean()) < 5 * max(sigma, 1.0), \
        (a.mean(), b.mean(), sigma)


@pytest.mark.parametrize('ptype', [1, 2])
def test_slice_photon_means_agree(runs, ptype):
    _, _, ours, ref = runs
    for field in ('n_photon', 'n_pe', 'n_electron', 'raw_area'):
        _spread_check(ours['truth'][field][ours['truth']['type'] == ptype],
                      ref['truth'][field][ref['truth']['type'] == ptype])


def test_slice_records_per_event_agree(runs):
    _, _, ours, ref = runs

    def per_event(rr):
        # S1 windows open a few us before the event time, S2s close < 2 ms after
        ev = (rr['time'] + EVENT_SPACING // 2) // EVENT_SPACING - 1
        return np.bincount(ev, minlength=N_EVENTS)

    a, b = per_event(ours['raw_records']), per_event(ref['raw_records'])
    assert len(a) == len(b) == N_EVENTS
    _spread_check(a, b)


def test_slice_record_area_tracks_truth(runs):
    _, cfg, ours, _ = runs
    rr, truth = ours['raw_records'], ours['truth']
    j = np.arange(110)[None, :]
    d = rr['data'].astype(np.int64)
    inside = (j < rr['length'][:, None]) & (d > 0)
    area_adc = np.clip(16000 - d, 0, None)[inside].sum()
    expect = (truth['raw_area'].sum() * np.mean(cfg['gains'])
              * cfg['current_2_adc'] / cfg['sample_duration'])
    assert 0.9 * expect < area_adc < 1.1 * expect


def test_slice_rerun_is_identical(runs):
    inst, cfg, ours, _ = runs
    again = Simulator(cfg, device='cpu').get_arrays(inst)
    for k in ('raw_records', 'truth'):
        assert again[k].tobytes() == ours[k].tobytes(), k
