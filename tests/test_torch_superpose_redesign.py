"""The superposition twins of wfsim_tpu_torch (``superpose_adc_ref``, slim
with and without the noise overlay, and ``superpose_adc_full_ref`` with
and without HE rows) against wfsim_tpu's ``gather_digitize``, on the window
batches of tests/superpose_cases.py: the shapes on which the row-tile
kernels of ``csrc/superpose_adc.cu`` take code paths of their own (a
window of 8195 samples, a row of 3,000 photons, photons whose taps reach
or pass the window end, empty rows and windows, windows that start off an
8-sample group).  tests/test_torch_cuda.py holds the kernels bitwise
against these twins on the same batches.

Tolerance: bitwise.  wfsim_tpu ships its grid without the noise overlay,
so its grid plus the overlay, wrapped to int16, is held against the
port's noisy grid (as in tests/test_torch_full_grid.py).  The twins add
the same float32 products in another order than wfsim_tpu (photon by
photon instead of per histogram bin, then a contraction), so an ADC value
within an f32 ulp of a .5 tie may round the other way; such tie samples
are counted and must be 0 at these seeds.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.pipeline.digitize import gather_digitize as jax_gather
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.ops.waveform import make_templates
from wfsim_tpu_torch.pipeline.digitize import (full_grid, gather_digitize,
                                               he_on)
from wfsim_tpu_torch.resources import load_config

from .reference_semantics import scatter_spe
from .superpose_cases import SUPERPOSE_CASES, superpose_case
from .test_torch_full_grid import bank_of, variant

K = 16
#: (grid, detector, bank width or None, deamplification factor)
GRIDS = (('slim', 'XENONnT', None, 0),
         ('slim with noise', 'XENONnT', 494, 0),
         ('full with HE rows', 'XENONnT', 801, 1),
         ('full without HE rows', 'XENON1T', 248, 1))


@pytest.fixture(scope='module')
def setups():
    """Both packages' bundles for each detector."""
    out = {}
    for det in ('XENONnT', 'XENON1T'):
        cj = jax_default_config(detector=det)
        c = default_config(detector=det)
        out[det] = ((cj, jax_build_params(cj, jax_load_config(cj)),
                     jax_build_constants(cj)),
                    (c, build_params(c, load_config(c), 'cpu'),
                     build_constants(c)))
    return out


def overlay(bank, nix, left, right, has, T):
    """(B, R, T) int32 noise overlay: row r of window w reads bank column
    r inside its window (numpy, reference rawdata.py:407-431)."""
    B, R = left.shape
    L, Cn = bank.shape
    out = np.zeros((B, R, T), np.int32)
    u = np.arange(T)
    for w in range(B):
        for r in np.flatnonzero(has[w, :Cn]):
            win = (u >= left[w, r]) & (u <= right[w, r])
            out[w, r] = np.where(win, bank[(nix[w] + u - left[w, r]) % L, r],
                                 0)
    return out


def count_ties(c, bad, t, ch, gain, pieces, n_ch, T):
    """How many of the mismatching TPC samples ``bad`` ((w, row, u) rows)
    are ADC ties: float64 W * current_2_adc within 1e-4 of a half-integer."""
    tmpl = make_templates(c['pe_pulse_ts'], c['pe_pulse_ys'])
    ties = 0
    for w, r, u in bad:
        lo, n = pieces[w, 0, :2]
        W = scatter_spe(t[lo:lo + n], ch[lo:lo + n], gain[lo:lo + n], 0,
                        n_ch, T, tmpl)
        x = W[r, u] * c['current_2_adc'] if r < n_ch else 0.0
        ties += abs(x - np.floor(x) - 0.5) < 1e-4
    return ties


@pytest.mark.parametrize('case', SUPERPOSE_CASES)
def test_twins_match_jax_on_kernel_paths(setups, case):
    t, ch, gain, pieces, T = superpose_case(case)
    B = len(pieces)
    nix = np.array([2700, 100, 1400][:B], np.int32)   # the first wraps
    n_cap = 512
    while n_cap < pieces[:, :, 1].max():
        n_cap *= 2
    for grid, det, width, factor in GRIDS:
        bank = None if width is None else bank_of(width)
        (cj, pj, kj), (c, pt, kt) = variant(setups[det], bank, factor)
        assert full_grid(pt, kt) == grid.startswith('full')
        assert (full_grid(pt, kt) and he_on(kt)) == (grid == 'full with HE '
                                                     'rows')
        rj = jax_gather(pj, kj, jnp.asarray(t), jnp.asarray(ch),
                        jnp.asarray(gain),
                        jnp.asarray(pieces.astype(np.int32)),
                        jnp.asarray(nix), n_samples=T, n_pieces=1,
                        n_cap=n_cap, max_intervals=K)
        rt = gather_digitize(pt, kt, torch.from_numpy(t), torch.from_numpy(ch),
                             torch.from_numpy(gain), torch.from_numpy(pieces),
                             torch.from_numpy(nix), n_samples=T,
                             max_intervals=K)
        got = rt['data'].numpy()
        left, right, has = (rt[k].numpy() for k in ('left_all', 'right_all',
                                                    'has'))
        np.testing.assert_array_equal(np.asarray(rj['left_all']), left)
        expect = np.asarray(rj['data']).astype(np.int32)
        if bank is not None:
            expect = expect + overlay(bank, nix, left, right, has, T)
        expect = expect.astype(np.int16)
        assert got.shape == expect.shape, grid
        bad = np.argwhere(expect != got)
        ties = count_ties(c, bad, t, ch, gain, pieces, kt.n_tpc_pmts, T)
        assert len(bad) == 0, (f'{grid}: {len(bad)} samples differ, {ties} '
                               f'ADC ties')
        for k in ('starts', 'ends'):
            np.testing.assert_array_equal(np.asarray(rj[k]), rt[k].numpy(),
                                          err_msg=f'{grid} {k}')

        # what the case is for
        s = t // 10
        if case == 'T = 8195':
            assert T % 8 and (right - left + 1).max() > 4096
        elif case == 'a row with 3,000 photons':
            assert np.bincount(ch).max() >= 3000
        elif case == 'photons at the window end':
            assert ((s >= T - 21) & (s < T)).any() and (s >= T).any()
            assert (right[has] == T - 1).any()
        elif case == 'an empty row and an empty window':
            assert not has[1].any() and not got[1].any()
            assert (~has[0, :kt.n_tpc_pmts]).any()
        else:
            assert len(np.unique(left[has] % 8)) == 8
