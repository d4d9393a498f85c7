"""PMT and electron afterpulses of wfsim_tpu_torch (the CPU twins of the
pmt_afterpulse kernels plus their torch glue, and the host instruction
synthesis) against wfsim_tpu.

Given-draw parity: the uniforms are drawn with jax.random exactly as
wfsim_tpu draws them inside ``pmt_afterpulse_photons`` (one split of the
key into three keys per element) and ``photon_summaries``, and handed to
the port.  Tolerances: bitwise for every output (the twin repeats the
float32 operations of wfsim_tpu one for one, and the CDF inversions and
searches are exact); the instruction synthesis is numpy in both packages
and must be identical from the same generator state; the rate and delay
oracle uses the bounds of tests/test_models.py.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.dtypes import instruction_dtype
from wfsim_tpu.models import afterpulse as jax_ap
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models import afterpulse as ap
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.resources import load_config

from .ap_inputs import N_CH, N_ROWS, ap_tables, photon_set


@pytest.fixture(scope='module')
def both():
    kw = dict(enable_pmt_afterpulses=True, photon_ap_cdfs=ap_tables())
    cj = jax_default_config(**kw)
    pj = jax_build_params(cj, jax_load_config(cj))
    kj = jax_build_constants(cj)
    c = default_config(**kw)
    pt = build_params(c, load_config(c), 'cpu')
    return (pj, kj), (c, pt, build_constants(c))


def jax_draws(key, n_elements, n):
    eks = jax.random.split(key, 3 * n_elements)
    return {name: np.stack([np.array(jax.random.uniform(eks[3 * e + j],
                                                          (n,)))
                            for e in range(n_elements)])
            for j, name in enumerate(('u0', 'u1', 'u2'))}


def test_tables_and_constants_match_jax(both):
    (pj, kj), (_, pt, kt) = both
    for name in ('pmt_ap_delay_cdf', 'pmt_ap_amp_cdf'):
        a = np.asarray(getattr(pj, name))
        b = getattr(pt, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert dataclasses.asdict(kj) == dataclasses.asdict(kt)
    assert kt.pmt_ap_element_uniform == (False, False, True)


@pytest.mark.parametrize('seed', [0, 1])
def test_pmt_afterpulse_photons_given_draws(both, seed):
    """Bitwise on the first ``total`` slots and on counts/t_min/t_max."""
    (pj, kj), (_, pt, kt) = both
    n = 40_000
    ph = photon_set(seed, n)
    key = jax.random.key(100 + seed)
    E = int(pt.pmt_ap_delay_cdf.shape[0])
    ph_j = {k: jnp.asarray(v.astype(np.int32) if k == 'truth_row' else v)
            for k, v in ph.items()}
    out_j, info_j = jax_ap.pmt_afterpulse_photons(
        pj, kj, ph_j, key, ap_capacity=8192, n_truth_rows=N_ROWS)
    ph_t = {k: torch.from_numpy(v.astype(np.int64) if k == 'truth_row'
                                else v) for k, v in ph.items()}
    draws = {k: torch.from_numpy(v) for k, v in jax_draws(key, E, n).items()}
    out_t, info_t = ap.pmt_afterpulse_photons(pt, kt, ph_t, draws,
                                              n_truth_rows=N_ROWS)
    total = int(info_j['total'])
    assert 0 < total < 8192
    assert info_t['total'] == total
    # both branches ran: uniform-element (amplitude 1) and CDF photons
    gains = out_t['gain'].numpy()
    assert 0 < np.sum(gains == pt.gains.numpy()[out_t['ch'].numpy()]) < total
    for k in ('t', 'ch', 'gain', 'truth_row'):
        a = np.asarray(out_j[k])[:total]
        b = out_t[k].numpy().astype(a.dtype)
        assert a.tobytes() == b.tobytes(), k
    assert out_t['valid'].all() and not out_t['is_dpe'].any()
    for k in ('counts', 't_min', 't_max'):
        np.testing.assert_array_equal(np.asarray(info_j[k]),
                                      info_t[k].numpy(), err_msg=k)


def test_pmt_afterpulse_twin_entry_matches(both):
    """pmt_afterpulse_photons_ref is the same function on the CPU."""
    _, (_, pt, kt) = both
    ph = {k: torch.from_numpy(v) for k, v in photon_set(3, 5000).items()}
    draws = ap.pmt_ap_draws(torch.Generator().manual_seed(3), 3, 5000, 'cpu')
    a, ia = ap.pmt_afterpulse_photons(pt, kt, ph, draws, n_truth_rows=N_ROWS)
    b, ib = ap.pmt_afterpulse_photons_ref(pt, kt, ph, draws,
                                          n_truth_rows=N_ROWS)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in ia:
        assert (ia[k] == ib[k]) if k == 'total' else torch.equal(ia[k], ib[k])


def test_pmt_afterpulse_rate_and_delay():
    """Port of tests/test_models.py::test_pmt_afterpulses_rate_and_delay
    with the synthetic tables (2.5 % per photon over two species)."""
    c = default_config(enable_pmt_afterpulses=True)
    pt = build_params(c, load_config(c), 'cpu')
    kt = build_constants(c)
    n = 50_000
    ph = dict(t=torch.zeros(n, dtype=torch.int32),
              ch=torch.from_numpy(np.random.default_rng(0).integers(
                  0, N_CH, n).astype(np.int32)),
              is_dpe=torch.zeros(n, dtype=torch.bool),
              valid=torch.ones(n, dtype=torch.bool),
              truth_row=torch.zeros(n, dtype=torch.int64))
    draws = ap.pmt_ap_draws(torch.Generator().manual_seed(3), 2, n, 'cpu')
    out, info = ap.pmt_afterpulse_photons(pt, kt, ph, draws, n_truth_rows=1)
    total = info['total']
    assert int(info['counts'][0]) == total
    assert 0.012 * n < total < 0.05 * n
    t = out['t'].numpy()
    assert t.min() >= -kt.pmt_ap_t_modifier
    assert 200 < np.median(t) < 4000
    assert (out['gain'] >= 0).all()


def test_photon_summaries_given_u():
    """Counts of valid photons; slots index the full array (invalid photons
    included), bitwise against wfsim_tpu with the same uniforms."""
    ph = photon_set(5, 3000)
    key = jax.random.key(9)
    n_inst = N_ROWS + 2          # two instructions without photons
    cj, tj = jax_ap.photon_summaries(
        {k: jnp.asarray(v.astype(np.int32) if k == 'truth_row' else v)
         for k, v in ph.items()}, key, n_inst=n_inst)
    u = np.array(jax.random.uniform(key, (n_inst, ap.K_CANDIDATES)))
    ct, tt = ap.photon_summaries(
        {k: torch.from_numpy(v) for k, v in ph.items()}, torch.from_numpy(u),
        n_inst=n_inst)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    assert ct.numpy().sum() == ph['valid'].sum()
    ct2, tt2 = ap.photon_summaries_ref(
        {k: torch.from_numpy(v) for k, v in ph.items()}, torch.from_numpy(u),
        n_inst=n_inst)
    assert torch.equal(ct, ct2) and torch.equal(tt, tt2)


@pytest.mark.parametrize('base_time', [10_000_000, 2_740_000_000])
def test_electron_afterpulse_instructions_match_jax(base_time):
    """generate_pi_el/pe_el_instructions from the same numpy generator
    state give identical instructions, including an absolute base past
    int32 (port of tests/test_models.py::test_pi_el_instructions_int64_base_time)."""
    kw = dict(enable_electron_afterpulses=True, enable_gate_afterpulses=True)
    cj, c = jax_default_config(**kw), default_config(**kw)
    rj, rt = jax_load_config(cj), load_config(c)
    src = np.zeros(3, dtype=instruction_dtype)
    src['type'] = 2
    src['amp'] = 1000
    src['event_number'] = [0, 1, 2]
    counts = np.array([50_000, 0, 30_000])
    cand = np.random.default_rng(4).integers(
        0, 1_000_000, (3, 16)).astype(np.int32)
    out = []
    for res, cfg, mod in ((rj, cj, jax_ap), (rt, c, ap)):
        rng = np.random.default_rng(5)
        pi = mod.generate_pi_el_instructions(cfg, res, rng, counts, cand,
                                             src, base_time)
        pe = mod.generate_pe_el_instructions(cfg, rng, counts, cand, src,
                                             base_time)
        out.append((pi, pe))
    (pi_j, pe_j), (pi_t, pe_t) = out
    for a, b in ((pi_j, pi_t), (pe_j, pe_t)):
        assert len(a) > 0
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert b['time'].dtype == np.int64
        assert (np.abs(b['time'].astype(np.float64) - base_time) < 5e9).all()
    assert set(pi_t['type']) == {4} and set(pe_t['type']) == {6}
    assert set(pi_t['event_number']) <= {0, 2}
