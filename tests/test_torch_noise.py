"""The noise overlay of wfsim_tpu_torch (the CPU twin of the noise-fused
superpose_adc kernel plus the digitize glue) against wfsim_tpu and the
numpy oracle of the reference semantics.

wfsim_tpu strips the overlay from its transport grid and re-adds it on the
host (``add_noise_host``); the port ships the noisy grid itself.  So the
port's records are held against wfsim_tpu's ``gather_digitize`` ->
``pack_records`` -> ``add_noise_host`` and against
tests/test_digitize_parity.py's ``numpy_digitize(..., noise=(bank, nix))``.
Tolerance: bitwise (integer adds; the superposition order question of
tests/test_torch_digitize.py applies unchanged, and tie samples must be 0
at these seeds).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.pipeline.digitize import (gather_digitize as jax_gather,
                                         pack_records as jax_pack,
                                         add_noise_host)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import (build_params, build_constants,
                                           params_from_numpy)
from wfsim_tpu_torch.ops.waveform import make_templates, noise_overlay_ref
from wfsim_tpu_torch.pipeline.digitize import gather_digitize, pack_records
from wfsim_tpu_torch.resources import load_config

from .test_digitize_parity import numpy_digitize
from .test_torch_host import export_jax_params

K = 16
T = 1024


@pytest.fixture(scope='module')
def setups():
    cj = jax_default_config(enable_noise=True)
    c = default_config(enable_noise=True)
    return ((cj, jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


def narrow(setups, n_ch):
    """Both bundles with the bank cut to its first ``n_ch`` channels."""
    (cj, pj, kj), (c, pt, kt) = setups
    pj = dataclasses.replace(pj, noise_data=pj.noise_data[:, :n_ch],
                             noise_ext=None)
    pt = dataclasses.replace(pt, noise_bank=pt.noise_bank[:n_ch].contiguous())
    return (cj, pj, kj), (c, pt, kt)


def photons(seed, n, n_ch):
    rng = np.random.default_rng(seed)
    t = rng.integers(1500, T * 10 - 3000, n).astype(np.int32)
    ch = rng.integers(0, n_ch, n).astype(np.int32)
    gain = rng.uniform(1e6, 3e6, n).astype(np.float32)
    return t, ch, gain


def run_both(setups, t, ch, gain, pieces, nix):
    """Same arena, pieces and noise offsets through both packages; returns
    (jax records with the noise re-added, torch records, torch grid)."""
    (cj, pj, kj), (c, pt, kt) = setups
    B, P = pieces.shape[:2]
    rj = jax_gather(pj, kj, jnp.asarray(t), jnp.asarray(ch), jnp.asarray(gain),
                    jnp.asarray(pieces.astype(np.int32)), jnp.asarray(nix),
                    n_samples=T, n_pieces=P, n_cap=1024, max_intervals=K)
    n_rec = int(rj['n_records'])
    pk = jax_pack(rj['data'], rj['left_all'], rj['starts'], rj['ends'],
                  rj['itv_valid'], n_channels_total=kj.n_tpc_pmts,
                  n_samples=T, max_intervals=K, max_records=max(n_rec, 1))
    meta = np.asarray(pk['rec_meta'])[:n_rec]
    data = np.array(pk['rec_data'])[:n_rec]
    left = np.asarray(rj['left_all'])[meta[:, 0], meta[:, 1]]
    add_noise_host(data, meta[:, 1], meta[:, 2], meta[:, 3], left,
                   nix[meta[:, 0]], np.asarray(pj.noise_data))
    rt = gather_digitize(pt, kt, torch.from_numpy(t), torch.from_numpy(ch),
                         torch.from_numpy(gain), torch.from_numpy(pieces),
                         torch.from_numpy(nix), n_samples=T,
                         max_intervals=K)
    rd, rm = pack_records(rt['data'], rt['left_all'], rt['starts'],
                          rt['ends'], rt['counts'])
    return (data, meta), (rd.numpy(), rm.numpy()), rt


def test_noise_bank_matches_jax(setups):
    """Channel-major int16 bank == wfsim_tpu's (L, Cn) bank transposed, in
    build_params and through params_from_numpy."""
    (_, pj, kj), (_, pt, _) = setups
    bank = np.asarray(pj.noise_data)
    assert pt.noise_bank.dtype == torch.int16
    np.testing.assert_array_equal(pt.noise_bank.numpy(), bank.T)
    tree = export_jax_params(pj)
    tree.pop('noise_ext')
    conv, _ = params_from_numpy(tree, dataclasses.asdict(kj), 'cpu')
    assert torch.equal(conv.noise_bank, pt.noise_bank)


@pytest.mark.parametrize('seed,where', [(0, 'middle'), (1, 'wraps'),
                                        (2, 'narrow bank')])
def test_noisy_records_match_jax_and_oracle(setups, seed, where):
    """Two windows; offsets in the bank's middle, or so close to its end
    that every window's trace wraps, or with a bank narrower than the TPC
    (rows past it get no noise)."""
    if where == 'narrow bank':
        setups = narrow(setups, 20)
    c = setups[1][0]
    bank = setups[0][1].noise_data
    L = int(bank.shape[0])
    n = 400
    t, ch, gain = photons(seed, n, 40)
    pieces = np.zeros((2, 2, 3), np.int64)
    pieces[0, 0] = (0, n // 2, 0)
    pieces[1, 0] = (n // 2, n - n // 2, 0)
    nix = (np.array([L // 3, 4567], np.int32) if where != 'wraps'
           else np.array([L - 300, L - 700], np.int32))
    (dj, mj), (dt, mt), _ = run_both(setups, t, ch, gain, pieces, nix)
    assert len(mt) > 50
    np.testing.assert_array_equal(mj, mt)
    np.testing.assert_array_equal(dj, dt)

    oracle = numpy_digitize(c, make_templates(c['pe_pulse_ts'],
                                              c['pe_pulse_ys']),
                            t[:n // 2].astype(np.int64), ch[:n // 2],
                            gain[:n // 2], T, 494,
                            noise=(np.asarray(bank), int(nix[0])))
    ours = {}
    for (w, cch, start, length, plen, rec_i), data in zip(mt, dt):
        if w == 0:
            ours.setdefault(int(cch), []).append(
                (int(start), int(length), int(plen), int(rec_i), data))
    oracle = {k: v for k, v in oracle.items() if v}
    assert set(ours) == set(oracle)
    for cch, recs in oracle.items():
        assert len(ours[cch]) == len(recs), cch
        for got, ref in zip(ours[cch], recs):
            assert got[:4] == ref[:4], (cch, got[:4], ref[:4])
            np.testing.assert_array_equal(got[4], ref[4].astype(np.int16))


def test_quiet_samples_and_zero_outside_window(setups):
    """Port of tests/test_models.py::test_noise_and_baseline: in-window
    quiet samples fluctuate around the baseline, samples past the window
    are exactly zero."""
    (_, _, _), (c, pt, kt) = setups
    rng = np.random.default_rng(1)
    n = 256
    t = torch.from_numpy(rng.integers(1500, 3000, n).astype(np.int32))
    ch = torch.from_numpy(rng.integers(0, 494, n).astype(np.int32))
    g = torch.full((n,), 2e6)
    out = gather_digitize(pt, kt, t, ch, g, torch.tensor([[[0, n, 0]]]),
                          torch.tensor([1234], dtype=torch.int32),
                          n_samples=512, max_intervals=32)
    data = out['data'][0].numpy()
    has = out['has'][0].numpy()
    cl, cr = out['left_all'][0].numpy(), out['right_all'][0].numpy()
    c0 = int(np.nonzero(has)[0][0])
    quiet = data[c0, cl[c0]:cl[c0] + 20]
    assert 15900 < quiet.mean() < 16100
    assert quiet.std() > 0.5
    assert cr[c0] + 2 < 512
    assert np.all(data[c0, cr[c0] + 1:] == 0)
    assert np.all(data[~has] == 0)


def test_overlay_is_the_only_difference_to_the_noise_free_grid(setups):
    """Noise off, the grid is the default configuration's; switching
    noise on adds exactly the bank overlay inside the windows (where
    nothing clips) and changes nothing outside them."""
    (_, _, _), (c, pt, kt) = setups
    c_off = default_config()
    p_off = build_params(c_off, load_config(c_off), 'cpu')
    k_off = build_constants(c_off)
    t, ch, gain = photons(4, 600, 494)
    args = (torch.from_numpy(t), torch.from_numpy(ch), torch.from_numpy(gain),
            torch.tensor([[[0, 300, 0]], [[300, 300, 0]]]))
    nix = torch.tensor([77, 99_000], dtype=torch.int32)
    on = gather_digitize(pt, kt, *args, nix, n_samples=T, max_intervals=K)
    off = gather_digitize(p_off, k_off, *args, n_samples=T, max_intervals=K)
    off2 = gather_digitize(p_off, k_off, *args, nix, n_samples=T,
                           max_intervals=K)
    assert torch.equal(off['data'], off2['data'])      # offsets ignored
    for k in ('left_all', 'right_all', 'has'):
        assert torch.equal(on[k], off[k]), k
    B, C = 2, 494
    overlay = noise_overlay_ref(pt.noise_bank, nix, on['left_all'].reshape(-1),
                                n_channels=C, n_samples=T).reshape(B, C, T)
    u = torch.arange(T)
    in_win = ((u >= on['left_all'][..., None]) & (u <= on['right_all'][..., None])
              & on['has'][..., None])
    d_on, d_off = on['data'].to(torch.int32), off['data'].to(torch.int32)
    unclipped = in_win & (d_on > 0) & (d_off > 0)
    assert unclipped.sum() > 10_000
    assert torch.equal((d_on - d_off)[unclipped], overlay[unclipped])
    assert torch.equal(d_on[~in_win], d_off[~in_win])
    assert (overlay[in_win] != 0).float().mean() > 0.5


def test_unported_noise_paths_raise(setups):
    """What still raises on the noise path: a missing noise_ix.  A noise
    file found nowhere takes the synthetic bank, as in wfsim_tpu.  A bank
    wider than the TPC takes the full digitizer grid; so does XENON1T, as
    the grid without HE rows (its 248 TPC rows, then zero rows: no noise
    past the TPC)."""
    (_, _, _), (c, pt, kt) = setups
    args = (torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            torch.ones(1), torch.tensor([[[0, 1, 0]]]),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather_digitize(pt, kt, *args[:4], n_samples=512)   # no noise_ix
    wide = dataclasses.replace(pt, noise_bank=torch.zeros((801, 8),
                                                          dtype=torch.int16))
    assert gather_digitize(wide, kt, *args, n_samples=512)['data'].shape \
        == (1, 801, 512)
    nowhere = load_config(default_config(enable_noise=True,
                                         noise_file='noise_bank.npz'))
    assert np.array_equal(nowhere.noise_bank,
                          load_config(default_config(
                              enable_noise=True)).noise_bank)
    x1t = dataclasses.replace(kt, detector='XENON1T', n_tpc_pmts=248,
                              n_top_pmts=127, he_channel_start=0,
                              he_channel_end=-1, high_energy_deamp_int=1)
    x1t_grid = gather_digitize(pt, x1t, *args, n_samples=512)
    assert x1t_grid['data'].shape == (1, 801, 512)
    assert x1t_grid['has'][0, 0] and not x1t_grid['has'][0, 248:].any()
    assert x1t_grid['data'][0, 0].any() and not x1t_grid['data'][0, 248:].any()
