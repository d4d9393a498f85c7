"""The XENON1T detector of wfsim_tpu_torch (248 TPC channels, 127 of them
top, no high-energy channel range) against wfsim_tpu, on the CPU twins.

- The full digitizer grid without HE rows (wfsim_tpu ``gather_digitize``
  with ``he_on`` false): the 248 TPC rows, then zero rows up to the 801
  digitizer channels; no HE copies, no sum row, no noise past the TPC.
  ``gather_digitize`` -> ``pack_records`` against wfsim_tpu's
  ``gather_digitize`` -> ``pack_records`` -> ``add_noise_host`` on the
  same photons and noise offsets: grid, windows, intervals and records
  bitwise, with factor 1 and with a noise bank wider than the TPC; and the
  same records from the slim grid.  ``digitize_window`` likewise.
- The ``xenon1t_full_grid`` slice: 8 bench events with factor 1 and
  per-PMT truth through ``Simulator(...).get_arrays`` of both packages
  (different draws by construction): identical dtypes, strax invariants,
  channels below 248 and no ``raw_records_he`` key, per-event record
  counts and per-type photon means within 5 sigma of the 8-event spread.
  The port's records with noise on are bitwise those of the same run on
  the slim grid (factor 0) at the same window framing
  (``split_digitize_gap_ns`` 0, which factor 1 implies).
- The port of tests/test_pipeline.py::test_xenon1t_detector_end_to_end.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from bench import _make_inst
from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.interface.simulator import Simulator as JaxSimulator
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.pipeline.digitize import digitize_window as jax_window
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import Simulator
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.dtypes import instruction_dtype
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                          superpose_adc_full_ref)
from wfsim_tpu_torch.pipeline.digitize import (digitize_window, full_grid,
                                               gather_digitize, he_on,
                                               pack_records, window_photons)
from wfsim_tpu_torch.resources import load_config

from .test_torch_full_grid import (K, T, bank_of, overlay, run_both,
                                   strax_valid, variant)

C, N_TOP, C_ALL = 248, 127, 801
N_EVENTS = 8
X1T = dict(detector='XENON1T', seed=1234, chunk_size=100,
           high_energy_deamplification_factor=1.0, per_pmt_truth=True)


@pytest.fixture(scope='module')
def setups():
    cj = jax_default_config(detector='XENON1T')
    c = default_config(detector='XENON1T')
    return ((cj, jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


def arena(seed, n_win, n):
    """``n`` photons a window over the 248 TPC channels, one piece each."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1500, T * 10 - 3000, n_win * n).astype(np.int32)
    ch = rng.integers(0, C, n_win * n).astype(np.int32)
    gain = rng.uniform(1e6, 3e6, n_win * n).astype(np.float32)
    pieces = np.zeros((n_win, 1, 3), np.int64)
    for w in range(n_win):
        pieces[w, 0] = (w * n, n, 0)
    return t, ch, gain, pieces


CASES = {
    'factor 1, noise off': (None, 1),
    'factor 1, 248-wide bank': (C, 1),
    'factor 0, 801-wide bank': (C_ALL, 0),
}


@pytest.mark.parametrize('case', list(CASES))
def test_no_he_grid_matches_jax(setups, case):
    width, factor = CASES[case]
    bank = None if width is None else bank_of(width)
    setups = variant(setups, bank, factor)
    (_, pt, kt) = setups[1]
    assert kt.n_tpc_pmts == C and not he_on(kt) and full_grid(pt, kt)
    t, ch, gain, pieces = arena(list(CASES).index(case), 2, 500)
    nix = np.array([1000, 3000 - 300], np.int32)      # the second wraps
    jx, th = run_both(setups, t, ch, gain, pieces, nix, bank)

    assert th['grid'].shape == (2, C_ALL, T)
    np.testing.assert_array_equal(jx['left'], th['left'])
    expect = jx['grid'].astype(np.int32)
    if bank is not None:
        expect = expect + overlay(bank, nix, th['left'], th['right'],
                                  th['has'])
    np.testing.assert_array_equal(th['grid'], expect.astype(np.int16))
    assert not th['grid'][:, C:].any() and not th['has'][:, C:].any()
    for k in ('starts', 'ends', 'valid', 'rec_data', 'rec_meta'):
        assert jx[k].shape == th[k].shape, k
        np.testing.assert_array_equal(jx[k], th[k], err_msg=k)
    assert len(th['rec_meta']) > 100 and th['rec_meta'][:, 1].max() < C

    # the slim grid of the same photons gives the same records
    args = [torch.from_numpy(x) for x in (t, ch, gain, pieces, nix)]
    slim = gather_digitize(pt, kt, *args, n_samples=T, max_intervals=K,
                           full=False)
    assert slim['data'].shape == (2, C, T)
    rs = pack_records(slim['data'], slim['left_all'], slim['starts'],
                      slim['ends'], slim['counts'])
    np.testing.assert_array_equal(rs[0].numpy(), th['rec_data'])
    np.testing.assert_array_equal(rs[1].numpy(), th['rec_meta'])


@pytest.mark.parametrize('noise,factor', [(False, 1), (True, 0), (True, 1)])
def test_digitize_window_matches_jax(setups, noise, factor):
    """One window, a few photons dropped by ``valid``; with noise an
    801-wide bank, whose columns past the TPC feed nothing."""
    bank = bank_of(C_ALL) if noise else None
    (_, pj, kj), (_, pt, kt) = variant(setups, bank, factor)
    rng = np.random.default_rng(12)
    n, Tw = 300, 512
    t = rng.integers(1500, 3000, n).astype(np.int32)
    ch = rng.integers(0, C, n).astype(np.int32)
    g = rng.uniform(1e6, 3e6, n).astype(np.float32)
    v = rng.random(n) > 0.05
    nix = 1234
    oj = jax_window(pj, kj, jnp.asarray(t), jnp.asarray(ch), jnp.asarray(g),
                    jnp.asarray(v), jax.random.key(0), jnp.int32(nix),
                    n_samples=Tw, max_intervals=32)
    ot = digitize_window(pt, kt, torch.from_numpy(t), torch.from_numpy(ch),
                         torch.from_numpy(g), torch.from_numpy(v), nix,
                         n_samples=Tw, max_intervals=32)
    for k in ('data', 'ch_mask', 'ch_left', 'ch_right', 'zle_starts',
              'zle_ends', 'zle_counts'):
        np.testing.assert_array_equal(np.asarray(oj[k]), ot[k].numpy(),
                                      err_msg=k)
    assert int(ot['zle_counts'].sum()) > 10
    data, mask = ot['data'].numpy(), ot['ch_mask'].numpy()
    assert data.shape == (C_ALL, Tw)
    assert mask[:C].any() and not mask[C:].any() and not data[C:].any()


def test_no_he_kernel_layout(setups):
    """A window without photons digitizes to zeros; the wrapper takes HE
    rows and a sum row together or neither."""
    (_, pt, kt) = variant(setups, bank_of(C_ALL), 1)[1]
    ph = window_photons(kt, torch.zeros(0, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                        torch.tensor([[[0, 0, 0]], [[0, 0, 0]]]), n_samples=64)
    args = (ph['t'], ph['gain'], ph['row_ptr'], pt.templates, ph['ch_left'],
            ph['ch_right'], ph['has'])
    kw = dict(current_2_adc=kt.current_2_adc, baseline=16000, n_samples=64,
              n_channels=C, n_channels_total=C_ALL, n_top=N_TOP,
              he_start=None, sum_channel=None, deamp=1,
              noise_bank=pt.noise_bank,
              noise_ix=torch.zeros(2, dtype=torch.int32))
    out = superpose_adc_full(*args, **kw)
    assert out.shape == (2, C_ALL, 64) and not out.any()
    assert torch.equal(out, superpose_adc_full_ref(*args, **kw))
    for bad in (dict(he_start=300), dict(sum_channel=800),
                dict(n_channels_total=200)):
        with pytest.raises(ValueError):
            superpose_adc_full(*args, **dict(kw, **bad))


# ---------------------------------------------------------------------------
# the xenon1t_full_grid slice


@pytest.fixture(scope='module')
def slice_runs():
    inst = bench_instructions(N_EVENTS, 2000, 300)
    ours = Simulator(default_config(**X1T), device='cpu').get_arrays(inst)
    ref = JaxSimulator(jax_default_config(**X1T)).get_arrays(
        _make_inst(N_EVENTS, 2000, 300))
    return ours, ref


def test_x1t_slice_records(slice_runs):
    ours, ref = slice_runs
    assert sorted(ours) == sorted(ref) == ['raw_records', 'truth']
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
    for out in (ours, ref):
        strax_valid(out['raw_records'], 0, C)
        truth = out['truth']
        assert (truth['type'] == 1).sum() == (truth['type'] == 2).sum() \
            == N_EVENTS
        assert truth['n_photon_per_pmt'].shape == (2 * N_EVENTS, C)
        np.testing.assert_array_equal(truth['n_photon_per_pmt'].sum(1),
                                      truth['n_photon'])

    def per_event(rr):
        ev = (rr['time'] + 2_000_000) // 4_000_000 - 1
        return np.bincount(ev, minlength=N_EVENTS)[:N_EVENTS]

    a, b = (per_event(o['raw_records']) for o in (ours, ref))
    sigma = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert abs(a.mean() - b.mean()) < 5 * max(sigma, 1.0), (a, b)


@pytest.mark.parametrize('ptype', [1, 2])
def test_x1t_slice_photon_means_agree(slice_runs, ptype):
    ours, ref = slice_runs
    for field in ('n_photon', 'n_pe', 'n_electron', 'raw_area'):
        x = ours['truth'][field][ours['truth']['type'] == ptype].astype(float)
        y = ref['truth'][field][ref['truth']['type'] == ptype].astype(float)
        sigma = np.sqrt(x.var(ddof=1) / len(x) + y.var(ddof=1) / len(y))
        assert abs(x.mean() - y.mean()) < 5 * max(sigma, 1.0), \
            (field, x.mean(), y.mean(), sigma)


def test_x1t_full_grid_records_equal_slim_grid():
    """Noise on: factor 1 (the grid without HE rows, windows not
    sub-split) and factor 0 (the slim grid) at the same framing give the
    same records, noise offsets included."""
    inst = bench_instructions(4, 2000, 300)
    base = dict(X1T, per_pmt_truth=False, enable_noise=True)
    full = Simulator(default_config(**base), device='cpu')
    slim = Simulator(default_config(**dict(
        base, high_energy_deamplification_factor=0.05,
        split_digitize_gap_ns=0)), device='cpu')
    rd_f, rd_s = full.sim.rawdata, slim.sim.rawdata
    assert full_grid(rd_f.params, rd_f.const)
    assert not full_grid(rd_s.params, rd_s.const)
    a, b = full.get_arrays(inst), slim.get_arrays(inst)
    assert len(a['raw_records']) > 1000
    assert a['raw_records'].tobytes() == b['raw_records'].tobytes()
    assert a['truth'].tobytes() == b['truth'].tobytes()


def test_xenon1t_detector_end_to_end():
    """Port of tests/test_pipeline.py::test_xenon1t_detector_end_to_end."""
    c = default_config(detector='XENON1T', seed=6)
    inst = np.zeros(2, dtype=instruction_dtype)
    inst['type'] = [1, 2]
    inst['time'] = 50_000_000
    inst['x'], inst['y'], inst['z'] = 5., 5., -40.
    inst['amp'] = [2000, 200]
    inst['recoil'] = 7
    out = Simulator(c, device='cpu').get_arrays(inst)
    rr = out['raw_records']
    assert len(rr) > 0
    assert rr['channel'].max() < 248
    assert 'raw_records_he' not in out
