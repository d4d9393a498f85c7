"""The realistic configuration end to end on the CPU: noise overlay, PMT
afterpulses and electron-afterpulse feedback (the JAX package's bench.py
"production realism" line), ``Simulator(...).get_arrays`` of
wfsim_tpu_torch and of wfsim_tpu on 8 events of the bench workload
(XENONnT, 494 channels).

The two packages draw different random numbers by construction, so records
cannot match one for one.  Checks, with their tolerances: identical
dtypes; one S1 and one S2 truth row per event and type-4 rows in both, the
type-4 counts within 5 sigma (Poisson); the PMT-afterpulse photon fraction
of each package inside the 1.2-5 % bound of tests/test_models.py and the
two within 5 sigma (binomial); records per event within 5 sigma of the
8-event spread; records strax-valid with noise on quiet samples; a rerun
with the same seed bitwise identical; and the feedback with gate
afterpulses on (port of tests/test_models.py::
test_electron_afterpulse_feedback_end_to_end).
"""
import numpy as np
import pytest

from bench import _make_inst
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.interface.simulator import Simulator as JaxSimulator

from wfsim_tpu_torch import Simulator, default_config
from wfsim_tpu_torch.dtypes import instruction_dtype
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.pipeline.rawdata import RawData

N_EVENTS = 8
EVENT_SPACING = 4_000_000
REALISTIC = dict(seed=1234, chunk_size=100, enable_noise=True,
                 enable_pmt_afterpulses=True,
                 enable_electron_afterpulses=True)


@pytest.fixture(scope='module')
def runs():
    inst = bench_instructions(N_EVENTS, 2000, 300)
    cfg = default_config(**REALISTIC)
    sim = Simulator(cfg, device='cpu')
    ours = sim.get_arrays(inst)
    jsim = JaxSimulator(jax_default_config(**REALISTIC))
    ref = jsim.get_arrays(_make_inst(N_EVENTS, 2000, 300))
    ap = (sim.sim.rawdata.diag.summary()['pmt_ap_photons'],
          jsim.sim.rawdata.diag.summary()['pmt_ap_photons'])
    return inst, cfg, ours, ref, ap


def test_realistic_dtypes(runs):
    _, _, ours, ref, _ = runs
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k


def test_realistic_truth_rows(runs):
    _, _, ours, ref, _ = runs
    n4 = []
    for out in (ours, ref):
        types = out['truth']['type']
        assert (types == 1).sum() == (types == 2).sum() == N_EVENTS
        assert set(np.unique(types)) <= {1, 2, 4}
        n4.append(int((types == 4).sum()))
        pi = out['truth'][types == 4]
        assert np.all(pi['n_photon'] > 0)         # empty rows are dropped
        assert np.all(pi['t_first_photon'] <= pi['t_last_photon'])
    assert min(n4) > 0
    assert abs(n4[0] - n4[1]) < 5 * np.sqrt(n4[0] + n4[1]) + 1, n4


def test_realistic_afterpulse_fraction(runs):
    _, _, ours, ref, ap = runs
    fr = []
    for out, n_ap in zip((ours, ref), ap):
        n = int(out['truth']['n_photon'].sum())
        fr.append((n_ap / n, n))
        assert 0.012 < n_ap / n < 0.05
    (p0, n0), (p1, n1) = fr
    sigma = np.sqrt(p0 * (1 - p0) / n0 + p1 * (1 - p1) / n1)
    assert abs(p0 - p1) < 5 * sigma, fr


def test_realistic_records_per_event_agree(runs):
    _, _, ours, ref, _ = runs

    def per_event(rr):
        ev = (rr['time'] + EVENT_SPACING // 2) // EVENT_SPACING - 1
        return np.bincount(ev, minlength=N_EVENTS)[:N_EVENTS]

    a, b = per_event(ours['raw_records']), per_event(ref['raw_records'])
    sigma = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert abs(a.mean() - b.mean()) < 5 * max(sigma, 1.0), (a, b)


def test_realistic_records_strax_valid(runs):
    _, _, ours, _, _ = runs
    rr = ours['raw_records']
    assert len(rr) > 1000
    assert np.all(np.diff(rr['time']) >= 0)
    for ch in np.unique(rr['channel']):
        assert np.all(np.diff(rr['time'][rr['channel'] == ch]) >= 0), ch
    assert np.all((rr['channel'] >= 0) & (rr['channel'] < 494))
    assert np.all((rr['length'] > 0) & (rr['length'] <= 110))
    np.testing.assert_array_equal(
        rr['length'], np.minimum(110, rr['pulse_length']
                                 - 110 * rr['record_i'].astype(np.int64)))
    j = np.arange(110)[None, :]
    assert np.all(rr['data'][j >= rr['length'][:, None]] == 0)
    inside = rr['data'][j < rr['length'][:, None]].astype(np.float64)
    assert inside.min() >= 0
    quiet = inside[np.abs(inside - 16000) < 30]
    assert 15990 < quiet.mean() < 16010 and 1.0 < quiet.std() < 10.0
    for k in ('raw_records_he', 'raw_records_aqmon'):
        assert len(ours[k]) == 0


def test_realistic_rerun_is_identical(runs):
    inst, cfg, ours, _, _ = runs
    again = Simulator(cfg, device='cpu').get_arrays(inst)
    for k in ('raw_records', 'truth'):
        assert again[k].tobytes() == ours[k].tobytes(), k


def test_electron_afterpulse_feedback_end_to_end():
    c = default_config(enable_electron_afterpulses=True,
                       enable_gate_afterpulses=True, seed=11)
    inst = np.zeros(1, dtype=instruction_dtype)
    inst['type'] = 2
    inst['time'] = 10_000_000
    inst['x'], inst['y'], inst['z'] = 5., 5., -30.
    inst['amp'] = 3000   # ~50k photons -> expect pi_el electrons
    inst['recoil'] = 7
    rd = RawData(c, device='cpu')
    truth = []
    n_windows = sum(1 for _ in rd.iter_windows(inst, truth_buffer=truth))
    types = {int(r['type']) for r in truth}
    assert 2 in types
    assert 4 in types and 6 in types, f'afterpulse truth rows: {types}'
    assert n_windows > 1
    d = rd.diag.summary()
    assert d['photons_pi_el'] > 0 and d['photons_pe_el'] > 0
