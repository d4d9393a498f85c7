"""Digitization of wfsim_tpu_torch (the CPU twins of the superpose_adc,
zle_intervals and pack_records kernels plus their torch glue) against
wfsim_tpu's gather_digitize + pack_records on the same photon arena and
piece table, and against the numpy oracle of the reference semantics in
tests/test_digitize_parity.py.

Tolerance: bitwise for the int16 grid, channel windows, ZLE intervals and
records.  The superposition adds the same float32 products in another
order than JAX (photon by photon instead of per histogram bin, then a
contraction), so an ADC value within an f32 ulp of a .5 tie may round the
other way; such tie samples are counted and must be 0 at these seeds.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.pipeline.digitize import (gather_digitize as jax_gather,
                                         pack_records as jax_pack)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.ops.waveform import (make_templates, superpose_adc,
                                          photons_to_waveform_ref)
from wfsim_tpu_torch.pipeline.digitize import (gather_digitize, pack_records,
                                               window_photons)
from wfsim_tpu_torch.resources import load_config

from .reference_semantics import scatter_spe
from .test_digitize_parity import numpy_digitize

K = 16


@pytest.fixture(scope='module')
def setups():
    cj = jax_default_config()
    c = default_config()
    return ((cj, jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


def run_both(setups, t, ch, gain, pieces, T):
    """Same arena and pieces through both packages; returns (jax, torch)
    dicts of grid, left, starts, ends, valid, rec_data, rec_meta."""
    (cj, pj, kj), (c, pt, kt) = setups
    B, P = pieces.shape[:2]
    n_cap = 512
    while n_cap < pieces[:, :, 1].sum(axis=1).max():
        n_cap *= 2
    rj = jax_gather(pj, kj, jnp.asarray(t), jnp.asarray(ch), jnp.asarray(gain),
                    jnp.asarray(pieces.astype(np.int32)),
                    jnp.zeros(B, jnp.int32), n_samples=T, n_pieces=P,
                    n_cap=n_cap, max_intervals=K)
    n_rec = int(rj['n_records'])
    pk = jax_pack(rj['data'], rj['left_all'], rj['starts'], rj['ends'],
                  rj['itv_valid'], n_channels_total=kj.n_tpc_pmts,
                  n_samples=T, max_intervals=K, max_records=max(n_rec, 1))
    jx = dict(grid=np.asarray(rj['data']), left=np.asarray(rj['left_all']),
              starts=np.asarray(rj['starts']), ends=np.asarray(rj['ends']),
              valid=np.asarray(rj['itv_valid']),
              rec_data=np.asarray(pk['rec_data'])[:n_rec],
              rec_meta=np.asarray(pk['rec_meta'])[:n_rec])
    rt = gather_digitize(pt, kt, torch.from_numpy(t), torch.from_numpy(ch),
                         torch.from_numpy(gain), torch.from_numpy(pieces),
                         n_samples=T, max_intervals=K)
    rd, rm = pack_records(rt['data'], rt['left_all'], rt['starts'],
                          rt['ends'], rt['counts'])
    kk = np.arange(K)[None, None, :]
    th = dict(grid=rt['data'].numpy(), left=rt['left_all'].numpy(),
              starts=rt['starts'].numpy(), ends=rt['ends'].numpy(),
              valid=kk < rt['counts'].numpy()[:, :, None],
              rec_data=rd.numpy(), rec_meta=rm.numpy())
    return jx, th


def tie_report(c, jx, th, t_win, ch_win, gain_win, T):
    """(mismatching samples, of which ADC ties) between the two grids; a
    tie is a sample whose float64 W * current_2_adc lies within 1e-4 of a
    half-integer."""
    bad = np.argwhere(jx['grid'] != th['grid'])
    ties = 0
    for w, cch, u in bad:
        W = scatter_spe(t_win[w], ch_win[w], gain_win[w], 0, 494, T,
                        make_templates(c['pe_pulse_ts'], c['pe_pulse_ys']))
        x = W[cch, u] * c['current_2_adc']
        ties += abs(x - np.floor(x) - 0.5) < 1e-4
    return len(bad), ties


def assert_same(c, jx, th, t_win, ch_win, gain_win, T):
    n_bad, n_tie = tie_report(c, jx, th, t_win, ch_win, gain_win, T)
    assert n_bad == 0, f'{n_bad} grid samples differ, {n_tie} of them ties'
    for k in ('left', 'starts', 'ends', 'valid', 'rec_data', 'rec_meta'):
        assert jx[k].shape == th[k].shape, k
        np.testing.assert_array_equal(jx[k], th[k], err_msg=k)


@pytest.mark.parametrize('seed', [0, 1])
def test_single_window_matches_jax_and_oracle(setups, seed):
    """The inputs of tests/test_digitize_parity.py::test_digitize_bitwise_parity."""
    c = setups[1][0]
    rng = np.random.default_rng(seed)
    T, n = 1024, 400
    t = rng.integers(1500, T * 10 - 3000, n).astype(np.int32)
    ch = rng.integers(0, 32, n).astype(np.int32)
    gain = rng.uniform(1e6, 3e6, n).astype(np.float32)
    pieces = np.zeros((1, 4, 3), np.int64)
    pieces[0, 0] = (0, n, 0)
    jx, th = run_both(setups, t, ch, gain, pieces, T)
    assert len(th['rec_meta']) > 50
    assert_same(c, jx, th, [t], [ch], [gain], T)

    oracle = numpy_digitize(c, make_templates(c['pe_pulse_ts'],
                                              c['pe_pulse_ys']),
                            t.astype(np.int64), ch, gain, T, 494)
    ours = {}
    for (w, cch, start, length, plen, rec_i), data in zip(th['rec_meta'],
                                                          th['rec_data']):
        ours.setdefault(int(cch), []).append(
            (int(start), int(length), int(plen), int(rec_i), data))
    assert set(ours) == set(oracle)
    for cch, recs in oracle.items():
        assert len(ours[cch]) == len(recs), cch
        for got, ref in zip(ours[cch], recs):
            assert got[:4] == ref[:4], (cch, got[:4], ref[:4])
            np.testing.assert_array_equal(got[4], ref[4].astype(np.int16))


def test_windows_and_pieces_match_jax(setups):
    """Three windows, up to three pieces each, pieces shifted into their
    window's frame by t_offset, dropped photons (channel -1) in the arena."""
    c = setups[1][0]
    rng = np.random.default_rng(2)
    T = 1024
    sizes = [150, 90, 200, 60, 120, 80]
    t = np.concatenate([rng.integers(0, 4000, n) for n in sizes]).astype(np.int32)
    ch = rng.integers(0, 48, len(t)).astype(np.int32)
    ch[rng.random(len(t)) < 0.03] = -1
    gain = rng.uniform(1e6, 3e6, len(t)).astype(np.float32)
    lo = np.concatenate([[0], np.cumsum(sizes)])
    pieces = np.zeros((3, 3, 3), np.int64)
    layout = {0: [(0, 1500), (1, 4000)], 1: [(2, 2000)],
              2: [(3, 1200), (4, 3000), (5, 5000)]}
    t_win, ch_win, g_win = [], [], []
    for w, plist in layout.items():
        tw, cw, gw = [], [], []
        for pi, (p, off) in enumerate(plist):
            pieces[w, pi] = (lo[p], sizes[p], off)
            sl = slice(lo[p], lo[p + 1])
            keep = ch[sl] >= 0
            tw.append(t[sl][keep] + off)
            cw.append(ch[sl][keep])
            gw.append(gain[sl][keep])
        t_win.append(np.concatenate(tw))
        ch_win.append(np.concatenate(cw))
        g_win.append(np.concatenate(gw))
    jx, th = run_both(setups, t, ch, gain, pieces, T)
    assert len(np.unique(th['rec_meta'][:, 0])) == 3
    assert_same(c, jx, th, t_win, ch_win, g_win, T)


def test_waveform_twin_matches_float64_oracle(setups):
    """photons_to_waveform_ref against the dense float64 scatter oracle
    (tolerance: 1e-5 of the peak current; f32 accumulation)."""
    c = setups[1][0]
    rng = np.random.default_rng(3)
    T, n = 512, 600
    t = np.sort(rng.integers(0, T * 10 + 100, n)).astype(np.int32)
    ch = np.sort(rng.integers(0, 8, n)).astype(np.int32)
    gain = rng.uniform(1e6, 3e6, n).astype(np.float32)
    tmpl = make_templates(c['pe_pulse_ts'], c['pe_pulse_ys'])
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(ch, minlength=8))])
    order = np.argsort(ch, kind='stable')
    W = photons_to_waveform_ref(torch.from_numpy(t[order]),
                                torch.from_numpy(gain[order]),
                                torch.from_numpy(row_ptr.astype(np.int32)),
                                torch.from_numpy(tmpl), n_samples=T).numpy()
    ref = scatter_spe(t, ch, gain, 0, 8, T, tmpl)
    np.testing.assert_allclose(W, ref, rtol=0, atol=1e-5 * ref.max())


def test_window_photons_extents(setups):
    """Row windows: [min sample - 102, max sample + 120] clipped to the grid,
    has only for rows with photons, photons sorted by row on
    [0, row_ptr[-1]) and a zero slot for the dropped photon past them."""
    (_, _, _), (c, _, kt) = setups
    t = torch.tensor([5000, 100, 7000, 6000], dtype=torch.int32)
    ch = torch.tensor([3, 3, 7, -1], dtype=torch.int32)
    g = torch.ones(4, dtype=torch.float32)
    pieces = torch.tensor([[[0, 4, 0]]])
    ph = window_photons(kt, t, ch, g, pieces, n_samples=1024)
    assert ph['has'].nonzero().squeeze(1).tolist() == [3, 7]
    assert ph['ch_left'][3] == 0 and ph['ch_right'][3] == 500 + 120
    assert ph['ch_left'][7] == 700 - 102 and ph['ch_right'][7] == 700 + 120
    n = int(ph['row_ptr'][-1])
    assert n == 3 and ph['t'].shape == (4,) and ph['gain'].shape == (4,)
    assert ph['t'][:n].tolist() == [5000, 100, 7000]
    assert ph['t'][n:].tolist() == [0] and ph['gain'][n:].tolist() == [0.0]
    assert ph['row_ptr'][3:9].tolist() == [0, 2, 2, 2, 2, 3]


def test_superpose_adc_rejects_negative_times(setups):
    pt = setups[1][1]
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        superpose_adc(torch.tensor([-3], dtype=torch.int32),
                      torch.ones(1), torch.tensor([0, 1], dtype=torch.int32),
                      pt.templates, 0 * one, one, torch.ones(1, dtype=torch.bool),
                      current_2_adc=1.0, baseline=16000, n_samples=16)
