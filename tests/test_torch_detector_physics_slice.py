"""The ``detector_physics`` configuration end to end on the CPU:
``Simulator(...).get_arrays`` of wfsim_tpu_torch and of wfsim_tpu on 8
events of the bench workload with the NEST inputs set (XENONnT, 494
channels; an S2 pattern map file written from a seed).

The two packages draw different random numbers by construction, so
records cannot match one for one.  Checks, with their tolerances: one
truth row per S1/S2; the field-distorted mean electron positions finite,
0.5 cm inside the true radius (the constant dummy FDC) within 0.05 cm and
equal between the packages within 1e-5 cm (they do not depend on the
draws); per-type mean photon and electron counts and photon time spreads
within 6 sigma of the 8-event spread; strax invariants of the records.
"""
import numpy as np
import pytest

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.interface.simulator import Simulator as JaxSimulator

from wfsim_tpu_torch import Simulator
from wfsim_tpu_torch.config import default_config, detector_physics_overrides
from wfsim_tpu_torch.interface import detector_physics_instructions
from wfsim_tpu_torch.resources.synthetic import write_pattern_map

from .test_torch_maps import jax_pattern_maps

N_EVENTS = 8


@pytest.fixture(scope='module')
def slice_runs(tmp_path_factory):
    pattern_file = write_pattern_map(
        tmp_path_factory.mktemp('dp') / 'pmap.json', 5)
    inst = detector_physics_instructions(N_EVENTS)
    over = detector_physics_overrides(pattern_file)
    ours = Simulator(default_config(seed=1234, chunk_size=100, **over),
                     device='cpu').get_arrays(inst)
    with jax_pattern_maps():
        ref = JaxSimulator(jax_default_config(seed=1234, chunk_size=100,
                                              **over)).get_arrays(inst)
    return inst, ours, ref


def test_detector_physics_slice_truth(slice_runs):
    inst, ours, ref = slice_runs
    for out in (ours, ref):
        truth = out['truth']
        assert len(truth) == len(inst)
        assert (truth['type'] == 1).sum() == (truth['type'] == 2).sum() \
            == N_EVENTS
        s2_rows = truth[truth['type'] == 2]
        assert np.all(np.isfinite(s2_rows['x_mean_electron']))
        assert np.all(np.isfinite(s2_rows['y_mean_electron']))
        # 0.5 cm inward at every radius
        r_true = np.hypot(s2_rows['x'], s2_rows['y'])
        r_obs = np.hypot(s2_rows['x_mean_electron'],
                         s2_rows['y_mean_electron'])
        np.testing.assert_allclose(r_obs, r_true - 0.5, atol=0.05)
    np.testing.assert_allclose(ours['truth']['x_mean_electron'],
                               ref['truth']['x_mean_electron'], atol=1e-5)


@pytest.mark.parametrize('ptype', [1, 2])
def test_detector_physics_slice_photons_agree(slice_runs, ptype):
    _, ours, ref = slice_runs
    a = ours['truth'][ours['truth']['type'] == ptype]
    b = ref['truth'][ref['truth']['type'] == ptype]
    for field in ('n_photon', 'n_electron', 't_sigma_photon'):
        x, y = a[field].astype(float), b[field].astype(float)
        sigma = np.sqrt(x.var(ddof=1) / len(x) + y.var(ddof=1) / len(y))
        assert abs(x.mean() - y.mean()) < 6 * max(sigma, 1.0), \
            (field, x.mean(), y.mean(), sigma)


def test_detector_physics_slice_records(slice_runs):
    _, ours, _ = slice_runs
    rr = ours['raw_records']
    assert len(rr) > 1000
    assert np.all(np.diff(rr['time']) >= 0)
    assert np.all((rr['channel'] >= 0) & (rr['channel'] < 494))
    assert np.all((rr['length'] > 0) & (rr['length'] <= 110))
    assert rr['data'].min() >= 0 and rr['data'].max() <= 16000
    assert np.all(rr['pulse_length'] >= rr['length'])
