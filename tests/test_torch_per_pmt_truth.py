"""Per-PMT truth (``per_pmt_truth``) of wfsim_tpu_torch against wfsim_tpu.

- The six per-(truth row, channel) sums given the same photons: wfsim_tpu's
  ``_pulse_truth`` against the port's plain twin ``pulse_truth_per_pmt_ref``
  on XENONnT (494 channels) and XENON1T (248), with invalid photons,
  photons without a channel and an empty row.  Counts exact; raw areas
  within rtol 1e-5 (wfsim_tpu scatter-adds float32 in an order of its own,
  the port sums in float64: ROADMAP Queue 3).  Over the channels the
  vectors sum to the row totals, over the bottom array to the ``*_bottom``
  sums of a run without per-PMT truth.
- ``pmt_response`` gives the keys wfsim_tpu gives: the totals and the
  ``*_per_pmt`` sums, no ``*_bottom`` ones.
- The slice: 8 bench events with ``per_pmt_truth`` through
  ``Simulator(...).get_arrays`` of both packages (different draws by
  construction): identical dtypes, vectors that sum to the totals in both,
  per-type means within 5 sigma of the 8-event spread; the port's records
  bitwise those of the same run without per-PMT truth (it draws nothing),
  and its vectors' bottom channels equal to that run's ``*_bottom``
  fields.  The port of tests/test_pipeline.py::test_per_pmt_truth_end_to_end.
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
from wfsim_tpu.models.pmt import (_pulse_truth as jax_pulse_truth,
                                  photon_time_stats as jax_time_stats,
                                  pmt_response as jax_pmt_response)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import Simulator, default_config
from wfsim_tpu_torch.dtypes import instruction_dtype
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.models.pmt import (PER_PMT_SUMS, TRUTH_SUMS,
                                        pmt_draws, pmt_response,
                                        pulse_truth_per_pmt,
                                        pulse_truth_per_pmt_ref,
                                        pulse_truth_ref)
from wfsim_tpu_torch.models import pmt
from wfsim_tpu_torch.resources import load_config

from .test_torch_pmt_truth_order import (emulate_per_pmt, emulate_row_truth,
                                         photon_terms, truth_case)

DETECTORS = {'XENONnT': (494, 253), 'XENON1T': (248, 127)}
N_EVENTS = 8


def bundles(detector):
    """Both packages' (params, constants) with per-PMT truth on."""
    cj = jax_default_config(detector=detector, per_pmt_truth=True)
    c = default_config(detector=detector, per_pmt_truth=True)
    return ((jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (build_params(c, load_config(c), 'cpu'), build_constants(c)))


def photons(seed, n_ch, rows=9, n=6000):
    """A photon batch as the photon pass leaves it: sorted truth rows (row
    3 empty), 2 % of the photons without a channel and 3 % more marked
    invalid with a channel, SPE-like gains, 21.9 % double-PE."""
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(n, np.ones(rows) / rows)
    counts[3] = 0
    n = int(counts.sum())
    ch = rng.integers(0, n_ch, n).astype(np.int32)
    ch[rng.random(n) < 0.02] = -1
    valid = (ch >= 0) & (rng.random(n) > 0.03)
    gain = (2e6 * np.clip(rng.normal(1.0, 0.4, n), 0.05, None)).astype(
        np.float32)
    ph = dict(t=rng.integers(0, 2_000_000, n).astype(np.int32), ch=ch,
              gain=gain, is_dpe=rng.random(n) < 0.219, valid=valid,
              truth_row=np.repeat(np.arange(rows), counts).astype(np.int32))
    edges = np.concatenate([[0], np.cumsum(counts)])
    return ph, edges


@pytest.mark.parametrize('detector', list(DETECTORS))
def test_per_pmt_sums_match_jax(detector):
    (pj, kj), (pt, kt) = bundles(detector)
    n_ch, n_top = DETECTORS[detector]
    assert tuple(pt.gains.shape) == (n_ch,)
    ph, edges = photons(list(DETECTORS).index(detector), n_ch)
    rows = len(edges) - 1
    ref = jax_pulse_truth(pj, kj, {k: jnp.asarray(v) for k, v in ph.items()},
                          rows, row_edges=jnp.asarray(edges.astype(np.int32)))
    ph_t = {k: torch.from_numpy(v) for k, v in ph.items()}
    ph_t['truth_row'] = ph_t['truth_row'].long()
    edges_t = torch.from_numpy(edges)
    ours = pulse_truth_per_pmt_ref(pt, kt, ph_t, edges_t)
    assert set(ours) == set(PER_PMT_SUMS)
    assert not any(k.endswith('_bottom') for k in ref)
    for k in PER_PMT_SUMS:
        a, b = np.asarray(ref[k]), ours[k].numpy()
        assert b.shape == a.shape == (rows, n_ch), k
        if k.startswith('raw_area'):
            assert b.dtype == np.float64
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=0, err_msg=k)
        else:
            assert b.dtype == np.int32
            np.testing.assert_array_equal(b, a.astype(np.int32), err_msg=k)
    assert not any(ours[k][3].any() for k in PER_PMT_SUMS)   # empty row
    assert ours['n_photon_per_pmt'].sum() == int(ph['valid'].sum())
    assert ours['n_photon_trigger_per_pmt'].sum() > 0

    # the wrapper runs the twin on CPU tensors; vectors sum to the row
    # totals, their bottom channels to the bottom-array sums
    assert all(torch.equal(v, ours[k]) for k, v in
               pulse_truth_per_pmt(pt, kt, ph_t, edges_t).items())
    tot = pulse_truth_ref(pt, kt, ph_t, edges_t)
    for name in TRUTH_SUMS[:6]:
        per = ours[name + '_per_pmt'].to(torch.float64)
        torch.testing.assert_close(per.sum(1), tot[name], rtol=1e-12, atol=0)
        torch.testing.assert_close(per[:, n_top:].sum(1),
                                   tot[name + '_bottom'], rtol=1e-12, atol=0)


@pytest.mark.parametrize('name', ['one row of 10^6', 'late times'])
def test_truth_cases_match_jax(name):
    """The truth kernels' hard cases (tests/test_torch_pmt_truth_order.py:
    a row of 10^6 photons beside short ones; rows near 2^30 ns) through
    wfsim_tpu's ``_pulse_truth`` (totals and bottom sums; per-PMT sums)
    and ``photon_time_stats``, against the port's twins and the numpy
    emulation of the kernels' arithmetic.  Counts, t_min and t_max
    bitwise; raw areas within rtol 1e-5 of wfsim_tpu's float32 sums, as
    the tests above; the moments within rtol 1e-12 of numpy's float64
    ones, as test_torch_physics.py::test_time_stats_exact_for_late_rows
    (wfsim_tpu's float32 cumsum over every row is ROADMAP Queue 3 F1)."""
    params, const, ph, edges = truth_case(name)
    R = edges.shape[0] - 1
    e = edges.numpy()
    ph_np = {k: v.numpy() for k, v in ph.items()}
    ph_j = {k: jnp.asarray(v) for k, v in ph_np.items()}
    e_j = jnp.asarray(e.astype(np.int32))
    terms = photon_terms(params, const, ph)
    emu, _ = emulate_row_truth(ph_np['t'], ph_np['valid'], e, terms)
    emu_pmt, _ = emulate_per_pmt(terms, e, int(params.gains.shape[0]))
    twin = pmt.pulse_truth_ref(params, const, ph, edges)
    twin.update(pmt.photon_time_stats_ref(ph['t'], ph['valid'],
                                          ph['truth_row'], R, edges))
    for per_pmt, ours in ((False, [twin, emu]),
                          (True, [pmt.pulse_truth_per_pmt_ref(
                              params, const, ph, edges), emu_pmt])):
        cj = jax_default_config(per_pmt_truth=per_pmt)
        pj, kj = jax_build_params(cj, jax_load_config(cj)), \
            jax_build_constants(cj)
        ref = {k: np.array(v) for k, v in jax_pulse_truth(
            pj, kj, ph_j, R, row_edges=e_j).items()}
        if not per_pmt:
            # wfsim_tpu sums the totals as differences of one float32
            # cumsum over the batch, which rounds a short row after the
            # 10^6 one at the running sum's scale (0.125 at 1.8e6): each
            # row's areas are taken from a call on that row alone
            for r in np.flatnonzero(np.diff(e)):
                one = jax_pulse_truth(
                    pj, kj, {k: v[e[r]:e[r + 1]] for k, v in ph_j.items()},
                    1, row_edges=jnp.asarray([0, e[r + 1] - e[r]], jnp.int32))
                for k in ref:
                    if 'area' in k:
                        ref[k][r] = np.asarray(one[k])[0]
            ref.update(jax_time_stats(ph_j['t'], ph_j['valid'],
                                      ph_j['truth_row'], R, row_edges=e_j))
        for got in ours:
            assert set(got) <= set(ref)
            for k in got:
                a, b = ref[k], np.asarray(got[k])
                if 'area' in k:
                    np.testing.assert_allclose(b, a, rtol=1e-5, atol=0,
                                               err_msg=k)
                elif k not in ('t_mean_offset', 't_sigma'):
                    np.testing.assert_array_equal(b, a.astype(b.dtype),
                                                  err_msg=k)
    t = ph_np['t'].astype(np.int64)
    for r in range(R):
        x = t[e[r]:e[r + 1]][ph_np['valid'][e[r]:e[r + 1]]]
        if not len(x):
            continue
        c = (x - x.min()).astype(np.float64)     # exact: spans below 2^53
        for got in (twin, emu):
            np.testing.assert_allclose(np.asarray(got['t_mean_offset'][r]),
                                       c.mean(), rtol=1e-12)
            np.testing.assert_allclose(np.asarray(got['t_sigma'][r]),
                                       c.std(), rtol=1e-12)


@pytest.mark.parametrize('detector', list(DETECTORS))
def test_pmt_response_keys_match_jax(detector):
    """With per-PMT truth both packages give the totals and the per-PMT
    sums, and no bottom-array sums."""
    (pj, kj), (pt, kt) = bundles(detector)
    n_ch, _ = DETECTORS[detector]
    ph, edges = photons(7, n_ch, rows=5, n=3000)
    rows = len(edges) - 1
    gen = torch.Generator().manual_seed(3)
    draws = pmt_draws(gen, len(ph['t']), 'cpu')
    _phj, trj = jax_pmt_response(
        pj, kj, jnp.asarray(ph['t']), jnp.asarray(ph['ch']),
        jnp.asarray(ph['valid']), jnp.asarray(ph['truth_row']),
        jax.random.split(jax.random.key(3), 4), n_truth_rows=rows,
        row_edges=jnp.asarray(edges.astype(np.int32)))
    _pht, trt = pmt_response(
        pt, kt, *(torch.from_numpy(ph[k]) for k in ('t', 'ch', 'valid')),
        torch.from_numpy(ph['truth_row']).long(), draws, n_truth_rows=rows,
        row_edges=torch.from_numpy(edges))
    ours = {k for k in trt if not k.startswith('photon_')}
    assert ours == set(trj) == set(TRUTH_SUMS[:6]) | set(PER_PMT_SUMS)
    for k in PER_PMT_SUMS:
        assert tuple(trt[k].shape) == (rows, n_ch)
    np.testing.assert_array_equal(trt['n_photon_per_pmt'].sum(1).numpy(),
                                  trt['n_photon'].numpy())


# ---------------------------------------------------------------------------
# the slice


@pytest.fixture(scope='module')
def slice_runs():
    inst = bench_instructions(N_EVENTS, 2000, 300)
    cfg = dict(seed=1234, chunk_size=100, per_pmt_truth=True)
    ours = Simulator(default_config(**cfg), device='cpu').get_arrays(inst)
    off = Simulator(default_config(**dict(cfg, per_pmt_truth=False)),
                    device='cpu').get_arrays(inst)
    ref = JaxSimulator(jax_default_config(**cfg)).get_arrays(
        _make_inst(N_EVENTS, 2000, 300))
    return ours, off, ref


def test_slice_dtypes_and_sums(slice_runs):
    ours, _off, ref = slice_runs
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
    for out in (ours, ref):
        truth = out['truth']
        assert (truth['type'] == 1).sum() == (truth['type'] == 2).sum() \
            == N_EVENTS
        assert truth['n_photon_per_pmt'].shape == (2 * N_EVENTS, 494)
        for name in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger'):
            np.testing.assert_array_equal(
                truth[name + '_per_pmt'].sum(1), truth[name], err_msg=name)
        for name in ('raw_area', 'raw_area_trigger'):
            np.testing.assert_allclose(truth[name + '_per_pmt'].sum(1),
                                       truth[name], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize('ptype', [1, 2])
def test_slice_per_pmt_means_agree(slice_runs, ptype):
    ours, _off, ref = slice_runs
    for field in ('n_photon', 'raw_area'):
        a = ours['truth'][ours['truth']['type'] == ptype]
        b = ref['truth'][ref['truth']['type'] == ptype]
        # photons per PMT on the first and the last channel block
        for sl in (slice(0, 253), slice(253, 494)):
            x = a[field + '_per_pmt'][:, sl].sum(1).astype(float)
            y = b[field + '_per_pmt'][:, sl].sum(1).astype(float)
            sigma = np.sqrt(x.var(ddof=1) / len(x) + y.var(ddof=1) / len(y))
            assert abs(x.mean() - y.mean()) < 5 * max(sigma, 1.0), \
                (field, sl, x.mean(), y.mean(), sigma)


def test_slice_per_pmt_draws_nothing(slice_runs):
    """Per-PMT truth on or off: the same records, and the vectors' bottom
    channels sum to the bottom-array fields of the run without them."""
    ours, off, _ref = slice_runs
    for k in ('raw_records', 'raw_records_he', 'raw_records_aqmon'):
        assert ours[k].tobytes() == off[k].tobytes(), k
    a, b = ours['truth'], off['truth']
    np.testing.assert_array_equal(a['time'], b['time'])
    for name in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger'):
        np.testing.assert_array_equal(a[name], b[name])
        np.testing.assert_array_equal(
            a[name + '_per_pmt'][:, 253:].sum(1), b[name + '_bottom'])
    for name in ('raw_area', 'raw_area_trigger'):
        np.testing.assert_array_equal(a[name], b[name])
        np.testing.assert_allclose(a[name + '_per_pmt'][:, 253:].sum(1),
                                   b[name + '_bottom'], rtol=1e-12)


def test_per_pmt_truth_end_to_end():
    """Port of tests/test_pipeline.py::test_per_pmt_truth_end_to_end."""
    c = default_config(per_pmt_truth=True, seed=13)
    inst = np.zeros(2, dtype=instruction_dtype)
    inst['type'] = [1, 2]
    inst['time'] = 40_000_000
    inst['x'], inst['y'], inst['z'] = 5., 5., -40.
    inst['amp'] = [3000, 200]
    inst['recoil'] = 7
    out = Simulator(c, device='cpu').get_arrays(inst)
    truth = out['truth']
    assert 'n_photon_per_pmt' in truth.dtype.names
    per = truth['n_photon_per_pmt']
    np.testing.assert_array_equal(per.sum(axis=1), truth['n_photon'])
    assert 'raw_area_per_pmt' in truth.dtype.names
    np.testing.assert_allclose(truth['raw_area_per_pmt'].sum(axis=1),
                               truth['raw_area'], rtol=1e-3)
