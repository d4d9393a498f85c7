"""``correct``: a sound run holds, the control and each fault of the
timed path fail (the CPU twins at a tiny size; the card's readings are in
PERF.md)."""
import contextlib

import pytest
import torch

from bench_port import harness
from bench_port.tests.conftest import tiny_run


def failing(checks):
    return [k for k, c in checks.items() if c['value'] > c['limit']]


def test_sound_run_is_correct(sound_and_control):
    out = sound_and_control
    assert out['correct'], out['checks']
    assert out['compared']['batches'] == 1
    assert out['compared']['records'] > 0
    assert out['compared']['truth_rows'] > 0
    assert list(out)[-1] == 'checks'


def test_control_fails(sound_and_control):
    control = sound_and_control['compared']['control']
    assert 'records_differing' in failing(control)


@contextlib.contextmanager
def _patched(owner, name, new):
    old = owner.__dict__[name]
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged_grid(sim):
    """The superposition returns the grid it was given: no photon adds."""
    from wfsim_tpu_torch.pipeline import digitize
    orig = digitize.superpose_adc_full

    def no_photons(t, gain, *a, **kw):
        return orig(t, torch.zeros_like(gain), *a, **kw)
    return _patched(digitize, 'superpose_adc_full', no_photons)


def half_batch(sim):
    """Each super-batch simulates half of its instructions."""
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    orig = RawData.simulate

    def half(self, instructions, order=None):
        if order is not None:
            order = order[:max(1, len(order) // 2)]
        return orig(self, instructions, order)
    return _patched(RawData, 'simulate', half)


def altered_record(sim):
    """Every record's first sample is off by one where it is produced."""
    from wfsim_tpu_torch.pipeline import rawdata
    orig = rawdata.pack_records

    def altered(*a, **kw):
        data, meta = orig(*a, **kw)
        data = data.clone()
        data[:, 0] += 1
        return data, meta
    return _patched(rawdata, 'pack_records', altered)


@pytest.mark.parametrize('fault, number', [
    (unchanged_grid, 'records_differing'),
    (half_batch, 'truth_missing'),
    (altered_record, 'records_differing'),
])
def test_fault_is_not_correct(tmp_path, fault, number):
    out = tiny_run(tmp_path, fault=fault)
    assert not out['correct']
    assert number in failing(out['checks'])


#: faults planted in the program's configuration alone, each with the
#: number that has to catch it.  At this tiny size the totals are small,
#: so the faults are the strong forms of those the card reads (PERF.md):
#: PMT afterpulses off with two batches compared, twenty times the
#: photoionization electrons, a tenth of the electron lifetime, the drift
#: 10 % slower, ten times the longitudinal diffusion, four times the S1
#: yield
PHYSICS_FAULTS = [
    (dict(enable_pmt_afterpulses=False), 'pmt_ap_z'),
    (dict(photoionization_modifier=20.0), 'ele_ap_z'),
    (dict(electron_lifetime_liquid=65000.0), 's2_electrons_z'),
    (dict(drift_velocity_liquid=0.0001335 * 0.9), 'electron_time_z'),
    (dict(diffusion_constant_longitudinal=2.935e-7), 'electron_spread_z'),
    (dict(s1_detection_efficiency=0.48), 's1_photons_z'),
]


@pytest.mark.parametrize('fault_config, number', PHYSICS_FAULTS,
                         ids=[n for _, n in PHYSICS_FAULTS])
def test_physics_fault_is_not_correct(tmp_path, fault_config, number):
    out = tiny_run(tmp_path, fault_config=fault_config, captures=2)
    assert not out['correct']
    assert number in failing(out['checks'])


def test_resource_files_are_held_to_their_recipes(tmp_path, monkeypatch):
    import json
    monkeypatch.setattr(harness, 'CACHE', tmp_path)
    bench = harness.load_benchmark()
    conf = harness.config_file(bench, 'xenonnt_he_full_grid')
    cfg = harness.program_config(conf, 1, 10)
    assert harness.reference_tables(conf, cfg)['files_differing'] == 0
    path = harness._resource_file(conf, cfg,
                                  conf['resources']['pmt_afterpulses'])
    ap = json.loads(path.read_text())
    ap['He']['delaytime_cdf'][-1] *= 2
    path.write_text(json.dumps(ap))
    assert harness.reference_tables(conf, cfg)['files_differing'] == 1


def test_measurement_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='card'):
        harness.run_cell('nt_he_grid.er', 1, 1.0, False)


def test_run_exits_without_the_card(monkeypatch, capsys):
    from bench_port import run
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = run.main(['--workload', 'nt_he_grid.er', '--seed', '1',
                   '--seconds', '1', '--trace', '0'])
    assert rc != 0
    assert capsys.readouterr().out == ''


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of each cell on the card is correct."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    for cell in ('nt_realistic.gamma', 'nt_he_grid.er'):
        out = harness.run_cell(cell, 2 ** 31 + 5, 5.0, False)
        assert out['correct'], out['checks']
