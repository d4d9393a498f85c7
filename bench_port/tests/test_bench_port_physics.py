"""The physics reference: its recipes are the program's synthetic assets,
and its expectations read right."""
import numpy as np
import pytest

from bench_port import physics
from bench_port.reference import synthetic_noise


def test_recipes_are_the_programs_assets():
    from wfsim_tpu_torch.resources import synthetic
    want = synthetic.synthetic_pmt_ap_cdfs(494)
    got = physics.pmt_ap_elements(494)
    assert list(got) == list(want)
    for name in want:
        for key, v in want[name].items():
            assert np.array_equal(np.asarray(got[name][key]), np.asarray(v))
    pmf = synthetic.synthetic_ele_ap_pmf()
    rate, bc, cdf = physics.ele_ap_pmf()
    assert rate == pmf.n
    assert np.array_equal(bc, pmf.bin_centers)
    assert np.array_equal(cdf, pmf.cdf)
    assert np.array_equal(synthetic_noise(7, 500, 2.3, 11),
                          synthetic.synthetic_noise(7, 500, seed=11))


def test_expectations():
    from wfsim_tpu_torch import default_config
    cfg = default_config('XENONnT')
    per_pe = physics.pmt_ap_per_pe(cfg, physics.pmt_ap_elements(494))
    assert per_pe == pytest.approx(0.025, rel=2e-3)
    assert physics.s1_photon_probability(cfg) == pytest.approx(
        494 * 14e-5 / 1.219 * 0.12)
    k = physics.ele_ap_electrons_per_photon(cfg, physics.ele_ap_pmf(),
                                            n_points=20_000)
    assert 0 < k < 5e-4
    assert 0 < physics.ele_ap_mean_lag(cfg, physics.ele_ap_pmf(),
                                       n_points=20_000) < 1e6


def test_instruction_times_are_found_by_key():
    dt = np.dtype([('type', 'i1'), ('time', 'i8'), ('amp', 'i4'),
                   ('x', 'f4'), ('y', 'f4'), ('z', 'f4')])
    inst = np.zeros(4, dt)
    inst['type'] = 2
    inst['time'] = [10, 20, 30, 40]
    inst['amp'] = [1, 2, 3, 4]
    inst['z'] = [-1, -2, -3, -4]
    rows = inst[[2, 0]].copy()
    rows['time'] = 0
    rows = np.concatenate([rows, inst[:1].copy()])
    rows['amp'][-1] = 99
    assert list(physics.instruction_times(inst, rows)) == [30, 10, -1]
