"""A configuration with only
``enable_field_dependencies['norm_drift_velocity']`` on (ROADMAP fault
F17): wfsim_tpu reads the field-dependency maps only
for another key (wfsim_tpu/resources/loader.py:491-493), so the drift
stays constant (``drift_velocity_scaling`` 1.0); the port builds and runs
the same configuration.  With any other key on, both read the maps and
scale the drift velocity (tests/test_torch_field_maps.py runs them).

Tolerances: the S2 pass as in tests/test_torch_photon_passes.py; the
constants equal to the default configuration's, exactly, so the 8-event
slice is the default run (held against wfsim_tpu in
tests/test_torch_slice.py) and is only checked to complete with records.
"""
import numpy as np
import pytest

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import Simulator, default_config
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.resources import load_config
from wfsim_tpu_torch.resources.loader import Resource

from .test_torch_photon_passes import check_s2_pass_given_draws

NORM_ONLY = dict(enable_field_dependencies={'norm_drift_velocity': True})


@pytest.fixture(scope='module')
def both():
    cj = jax_default_config(**NORM_ONLY)
    c = default_config(**NORM_ONLY)
    return ((jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


def test_norm_drift_velocity_alone_keeps_constant_drift(both):
    (_pj, kj), (c, _pt, kt) = both
    assert c['enable_field_dependencies']['norm_drift_velocity']
    assert kj.drift_velocity_scaling == kt.drift_velocity_scaling == 1.0
    assert kt == build_constants(default_config())
    # any other key reads the field-dependency maps (the constant dummy
    # of 1 by default), so the scaling is the drift velocity over 1e-4,
    # as in wfsim_tpu
    for key in ('drift_speed_map', 'survival_probability_map'):
        over = dict(enable_field_dependencies={
            'norm_drift_velocity': True, key: True})
        res = Resource(default_config(**over))
        assert res.drift_velocity_scaling == jax_load_config(
            jax_default_config(**over)).drift_velocity_scaling
        assert res.drift_velocity_scaling == pytest.approx(1.335)


def test_norm_drift_velocity_alone_s2_pass_matches_jax(both):
    check_s2_pass_given_draws(both)


def test_norm_drift_velocity_alone_runs_a_slice():
    inst = bench_instructions(8, 2000, 300)
    out = Simulator(default_config(seed=1234, chunk_size=100, **NORM_ONLY),
                    device='cpu').get_arrays(inst)
    rr = out['raw_records']
    assert len(rr) > 1000 and len(out['truth']) == len(inst)
    assert (rr['length'] > 0).all() and (rr['length'] <= 110).all()
    assert (np.diff(rr['time']) >= 0).all()
