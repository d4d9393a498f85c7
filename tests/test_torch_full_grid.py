"""The full XENONnT digitizer grid of wfsim_tpu_torch (high-energy copies of
the top array, the bottom-array sum channel, noise on every banked row,
``raw_records_he``) against wfsim_tpu, on the CPU twins.

- ``gather_digitize`` -> ``pack_records`` against wfsim_tpu's
  ``gather_digitize`` -> ``pack_records`` -> ``add_noise_host`` on the
  same arena, pieces and noise offsets: records, intervals, HE rows and
  the sum row bitwise.  wfsim_tpu ships the grid without its noise overlay
  (the residual view), so its grid plus the overlay, wrapped to int16, is
  held against the port's noisy grid.  Tie samples (the superposition
  order question of tests/test_torch_digitize.py) are counted and must be
  0 at these seeds.
- ``digitize_window`` against wfsim_tpu's: grid, masks, windows and
  intervals bitwise.
- The three resource files of a production configuration, read by both
  packages: tensors equal.
- The ``he_full_grid`` slice end to end on 8 bench events: strax
  invariants, the raw_records_he / raw_records_aqmon split, and with noise
  off every HE record a copy of its TPC record (in both packages).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from wfsim_tpu.pipeline.digitize import (gather_digitize as jax_gather,
                                         pack_records as jax_pack,
                                         digitize_window as jax_window,
                                         add_noise_host)
from wfsim_tpu.resources.loader import load_config as jax_load_config

from wfsim_tpu_torch import Simulator
from wfsim_tpu_torch.config import default_config, he_full_grid_overrides
from wfsim_tpu_torch.interface import bench_instructions
from wfsim_tpu_torch.models.params import (build_params, build_constants,
                                           params_from_numpy)
from wfsim_tpu_torch.ops.waveform import (make_templates, superpose_adc_full,
                                          superpose_adc_full_ref)
from wfsim_tpu_torch.pipeline.digitize import (gather_digitize, pack_records,
                                               digitize_window, full_grid,
                                               window_photons)
from wfsim_tpu_torch.pipeline.rawdata import RawData, _Pulse
from wfsim_tpu_torch.resources import load_config
from wfsim_tpu_torch.resources.synthetic import (synthetic_noise,
                                                 write_production_files)

from .reference_semantics import scatter_spe
from .test_torch_host import export_jax_params

ROOT = Path(__file__).resolve().parent.parent
K = 16
T = 1024
C, N_TOP, HE_LO, HE_HI, SUM_CH, C_ALL = 494, 253, 500, 753, 800, 801


@pytest.fixture(scope='module')
def setups():
    """Both bundles of the noise-free default config; noise and factor are
    set per case with dataclasses.replace."""
    cj = jax_default_config()
    c = default_config()
    return ((cj, jax_build_params(cj, jax_load_config(cj)),
             jax_build_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


def variant(setups, bank, factor):
    """Both bundles with the (L, Cn) ``bank`` (None: noise off) and the
    integer deamplification factor ``factor``."""
    (cj, pj, kj), (c, pt, kt) = setups
    on = bank is not None
    kj = dataclasses.replace(kj, enable_noise=on, high_energy_deamp_int=factor)
    kt = dataclasses.replace(kt, enable_noise=on, high_energy_deamp_int=factor)
    if on:
        pj = dataclasses.replace(pj, noise_data=jnp.asarray(
            bank.astype(np.int32)), noise_ext=None)
        pt = dataclasses.replace(pt, noise_bank=torch.from_numpy(
            np.ascontiguousarray(bank.T.astype(np.int16))))
    return (cj, pj, kj), (c, pt, kt)


def bank_of(width, length=3000, seed=9):
    return synthetic_noise(C_ALL, length, seed=seed)[:, :width]


def arena(seed, n_win, n, neg_frac=0.0, neg_scale=0.2):
    """``n`` photons a window over all TPC channels, one piece per window;
    a fraction ``neg_frac`` of them with a negative gain ``neg_scale`` times
    the usual magnitude (a charge below the pedestal: positive ADC)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1500, T * 10 - 3000, n_win * n).astype(np.int32)
    ch = rng.integers(0, C, n_win * n).astype(np.int32)
    gain = rng.uniform(1e6, 3e6, n_win * n)
    gain = np.where(rng.random(n_win * n) < neg_frac, -neg_scale * gain, gain)
    pieces = np.zeros((n_win, 1, 3), np.int64)
    for w in range(n_win):
        pieces[w, 0] = (w * n, n, 0)
    return t, ch, gain.astype(np.float32), pieces


def overlay(bank, nix, left, right, has):
    """(B, C_all, T) int32 noise overlay of the full grid: row r of window
    w reads bank column r inside its window (numpy, reference
    rawdata.py:407-431)."""
    B = left.shape[0]
    L, Cn = bank.shape
    out = np.zeros((B, C_ALL, T), np.int32)
    u = np.arange(T)
    for w in range(B):
        for r in range(Cn):
            if has[w, r]:
                win = (u >= left[w, r]) & (u <= right[w, r])
                col = (nix[w] + u - left[w, r]) % L
                out[w, r] = np.where(win, bank[col, r], 0)
    return out


def run_both(setups, t, ch, gain, pieces, nix, bank):
    (cj, pj, kj), (c, pt, kt) = setups
    B, P = pieces.shape[:2]
    rj = jax_gather(pj, kj, jnp.asarray(t), jnp.asarray(ch), jnp.asarray(gain),
                    jnp.asarray(pieces.astype(np.int32)), jnp.asarray(nix),
                    n_samples=T, n_pieces=P, n_cap=1024, max_intervals=K)
    n_rec = int(rj['n_records'])
    pk = jax_pack(rj['data'], rj['left_all'], rj['starts'], rj['ends'],
                  rj['itv_valid'], n_channels_total=C_ALL, n_samples=T,
                  max_intervals=K, max_records=max(n_rec, 1))
    meta = np.asarray(pk['rec_meta'])[:n_rec]
    data = np.array(pk['rec_data'])[:n_rec]
    left = np.asarray(rj['left_all'])
    if bank is not None:
        add_noise_host(data, meta[:, 1], meta[:, 2], meta[:, 3],
                       left[meta[:, 0], meta[:, 1]], nix[meta[:, 0]], bank)
    jx = dict(grid=np.asarray(rj['data']), left=left,
              starts=np.asarray(rj['starts']), ends=np.asarray(rj['ends']),
              valid=np.asarray(rj['itv_valid']), rec_data=data, rec_meta=meta)
    rt = gather_digitize(pt, kt, torch.from_numpy(t), torch.from_numpy(ch),
                         torch.from_numpy(gain), torch.from_numpy(pieces),
                         torch.from_numpy(nix), n_samples=T, max_intervals=K)
    rd, rm = pack_records(rt['data'], rt['left_all'], rt['starts'],
                          rt['ends'], rt['counts'])
    kk = np.arange(K)[None, None, :]
    th = dict(grid=rt['data'].numpy(), left=rt['left_all'].numpy(),
              right=rt['right_all'].numpy(), has=rt['has'].numpy(),
              starts=rt['starts'].numpy(), ends=rt['ends'].numpy(),
              valid=kk < rt['counts'].numpy()[:, :, None],
              rec_data=rd.numpy(), rec_meta=rm.numpy())
    return jx, th


def count_ties(c, bad, t, ch, gain, pieces):
    """How many of the mismatching TPC samples ``bad`` ((w, row, u) rows)
    are ADC ties: float64 W * current_2_adc within 1e-4 of a half-integer."""
    tmpl = make_templates(c['pe_pulse_ts'], c['pe_pulse_ys'])
    ties = 0
    for w, r, u in bad:
        lo, n = pieces[w, 0, :2]
        W = scatter_spe(t[lo:lo + n], ch[lo:lo + n], gain[lo:lo + n], 0, C,
                        T, tmpl)
        x = W[r, u] * c['current_2_adc']
        ties += r < C and abs(x - np.floor(x) - 0.5) < 1e-4
    return ties


CASES = {
    'factor 0, 801-wide bank': (801, 0, 0.0),
    'factor 1, 494-wide bank': (494, 1, 0.0),
    'factor 1, 801-wide bank': (801, 1, 0.0),
    'factor 1, noise off': (None, 1, 0.0),
    'factor 2000, int16 wrap': (801, 2000, 0.1),
}


@pytest.mark.parametrize('case', list(CASES))
def test_full_grid_matches_jax(setups, case):
    width, factor, neg = CASES[case]
    bank = None if width is None else bank_of(width)
    setups = variant(setups, bank, factor)
    c = setups[1][0]
    assert full_grid(setups[1][1], setups[1][2])
    t, ch, gain, pieces = arena(list(CASES).index(case), 2, 700, neg)
    nix = np.array([1000, 3000 - 300], np.int32)      # the second wraps
    jx, th = run_both(setups, t, ch, gain, pieces, nix, bank)

    assert th['grid'].shape == (2, C_ALL, T)
    np.testing.assert_array_equal(jx['left'], th['left'])
    expect = jx['grid'].astype(np.int32)
    if bank is not None:
        expect = expect + overlay(bank, nix, th['left'], th['right'],
                                  th['has'])
    expect = expect.astype(np.int16)              # wraps like astype(int16)
    bad = np.argwhere(expect != th['grid'])
    ties = count_ties(c, bad, t, ch, gain, pieces)
    assert len(bad) == 0, f'{len(bad)} grid samples differ, {ties} ADC ties'
    # the HE rows and the sum row by name (already inside the grid check)
    np.testing.assert_array_equal(th['grid'][:, SUM_CH],
                                  jx['grid'][:, SUM_CH])
    np.testing.assert_array_equal(th['grid'][:, HE_LO:HE_HI],
                                  expect[:, HE_LO:HE_HI])
    for k in ('starts', 'ends', 'valid', 'rec_data', 'rec_meta'):
        assert jx[k].shape == th[k].shape, k
        np.testing.assert_array_equal(jx[k], th[k], err_msg=k)

    he_recs = (th['rec_meta'][:, 1] >= HE_LO) & (th['rec_meta'][:, 1] < HE_HI)
    assert len(th['rec_meta']) > 100
    assert not np.any(th['rec_meta'][:, 1] == SUM_CH)   # sum row: no window
    if factor:
        assert he_recs.sum() > 20
        assert np.any(th['grid'][:, SUM_CH] != 0)
    else:
        assert not he_recs.any() and not np.any(th['grid'][:, SUM_CH])
    if factor == 2000:
        # both wrapped past int16: in-window HE samples are >= 0 before the
        # cast, and the exact sum is a multiple of 2000
        assert np.any(th['grid'][:, HE_LO:HE_HI] < 0)
        assert np.any(th['grid'][:, SUM_CH].astype(np.int64) % 2000)


@pytest.mark.parametrize('noise,factor', [(False, 0), (False, 1), (True, 0),
                                          (True, 1)])
def test_digitize_window_matches_jax(setups, noise, factor):
    """One window, a few photons dropped by ``valid``; with noise the
    801-wide bank.  Also the properties of tests/test_models.py::
    test_noise_and_baseline."""
    bank = bank_of(801) if noise else None
    (_, pj, kj), (_, pt, kt) = variant(setups, bank, factor)
    rng = np.random.default_rng(11)
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
    data = ot['data'].numpy()
    mask = ot['ch_mask'].numpy()
    cl, cr = ot['ch_left'].numpy(), ot['ch_right'].numpy()
    assert data.shape == (C_ALL, Tw)
    assert np.array_equal(mask[HE_LO:HE_HI], mask[:N_TOP]) and mask.any()
    assert not mask[SUM_CH] and not mask[C:HE_LO].any()
    c0 = int(np.nonzero(mask)[0][0])
    quiet = data[c0, cl[c0]:cl[c0] + 20]
    assert 15900 < quiet.mean() < 16100
    if noise:
        assert quiet.std() > 0.5
    assert cr[c0] + 2 < Tw and np.all(data[c0, cr[c0] + 1:] == 0)
    assert np.all(data[~mask & (np.arange(C_ALL) != SUM_CH)] == 0)


def test_full_grid_refuses_values_past_16_bits(setups):
    """Where |adc x factor| lifts an in-window sample to 2^16 or more, its
    int16 sample no longer says whether wfsim_tpu's int32 value is below
    the ZLE threshold: the port raises instead of guessing."""
    (_, pt, kt) = variant(setups, bank_of(801), 2000)[1]
    t, ch, gain, pieces = arena(4, 2, 700, 0.1, neg_scale=1.0)
    with pytest.raises(OverflowError):
        gather_digitize(pt, kt, torch.from_numpy(t), torch.from_numpy(ch),
                        torch.from_numpy(gain), torch.from_numpy(pieces),
                        torch.tensor([5, 6], dtype=torch.int32),
                        n_samples=T, max_intervals=K)


def test_empty_window_and_layout_checks(setups):
    """A window without photons digitizes to zeros (sum row included); the
    wrapper refuses a grid layout the kernel does not take."""
    (_, pt, kt) = variant(setups, bank_of(801), 1)[1]
    ph = window_photons(kt, torch.zeros(0, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                        torch.tensor([[[0, 0, 0]], [[0, 0, 0]]]), n_samples=64)
    args = (ph['t'], ph['gain'], ph['row_ptr'], pt.templates, ph['ch_left'],
            ph['ch_right'], ph['has'])
    kw = dict(current_2_adc=kt.current_2_adc, baseline=16000, n_samples=64,
              n_channels=C, n_channels_total=C_ALL, n_top=N_TOP,
              he_start=HE_LO, sum_channel=SUM_CH, deamp=1,
              noise_bank=pt.noise_bank,
              noise_ix=torch.zeros(2, dtype=torch.int32))
    out = superpose_adc_full(*args, **kw)
    assert out.shape == (2, C_ALL, 64) and not out.any()
    assert torch.equal(out, superpose_adc_full_ref(*args, **kw))
    for bad in (dict(he_start=400), dict(sum_channel=700),
                dict(sum_channel=801), dict(deamp=2 ** 31)):
        with pytest.raises(ValueError):
            superpose_adc_full(*args, **dict(kw, **bad))


# ---------------------------------------------------------------------------
# resource files


@pytest.fixture(scope='module')
def aux_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('aux')
    write_production_files(d, seed=5, noise_length=20_000)
    return d


def both_resources(aux_dir, **extra):
    ov = dict(he_full_grid_overrides(aux_dir), **extra)
    cj = jax_default_config(seed=1234, **ov)
    c = default_config(seed=1234, **ov)
    return (cj, jax_load_config(cj)), (c, load_config(c))


def test_noise_file_matches_jax(aux_dir):
    (cj, rj), (c, rt) = both_resources(aux_dir)
    assert rt.noise_bank.shape == (C_ALL, 20_000)
    np.testing.assert_array_equal(rt.noise_bank, np.asarray(rj.noise_data).T)
    pj, pt = jax_build_params(cj, rj), build_params(c, rt, 'cpu')
    np.testing.assert_array_equal(pt.noise_bank.numpy(),
                                  np.asarray(pj.noise_data).T)
    np.testing.assert_array_equal(pt.zle_thresholds.numpy(),
                                  np.asarray(pj.zle_thresholds))
    assert pt.zle_thresholds.shape == (C_ALL,)
    assert full_grid(pt, build_constants(c))
    tree = export_jax_params(pj)
    tree.pop('noise_ext')
    conv, _ = params_from_numpy(tree, dataclasses.asdict(
        jax_build_constants(cj)), 'cpu')
    assert torch.equal(conv.noise_bank, pt.noise_bank)
    assert torch.equal(conv.zle_thresholds, pt.zle_thresholds)


def test_pmt_ap_file_matches_jax(aux_dir):
    (cj, rj), (c, rt) = both_resources(aux_dir)
    pj, pt = jax_build_params(cj, rj), build_params(c, rt, 'cpu')
    for k in ('pmt_ap_delay_cdf', 'pmt_ap_amp_cdf'):
        a, b = np.asarray(getattr(pj, k)), getattr(pt, k).numpy()
        assert a.shape == b.shape == (2, C) + a.shape[2:], k
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert dataclasses.asdict(jax_build_constants(cj)) == \
        dataclasses.asdict(build_constants(c))


def test_spe_file_matches_jax(aux_dir):
    (_, rj), (_, rt) = both_resources(aux_dir)
    a, b = np.asarray(rj.uniform_to_pe), np.asarray(rt.uniform_to_pe)
    assert a.shape == b.shape == (C, 2001)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_spe_csv_reads_without_pandas(aux_dir, tmp_path):
    """``spe_table_from_csv`` in a process where importing pandas fails."""
    out = tmp_path / 'table.npy'
    code = ('import sys; sys.modules["pandas"] = None; '
            'import numpy as np; '
            'from wfsim_tpu_torch.resources.spe import spe_table_from_csv; '
            f'np.save({str(out)!r}, spe_table_from_csv('
            f'{str(aux_dir / "spe.csv")!r}, 494)); '
            'assert sys.modules["pandas"] is None')
    subprocess.run([sys.executable, '-c', code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)))
    (_, _), (_, rt) = both_resources(aux_dir)
    np.testing.assert_array_equal(np.load(out), rt.uniform_to_pe)


# ---------------------------------------------------------------------------
# the he_full_grid slice


N_EVENTS = 8


@pytest.fixture(scope='module')
def slice_runs(aux_dir):
    inst = bench_instructions(N_EVENTS, 2000, 300)
    ov = he_full_grid_overrides(aux_dir)
    noisy = Simulator(default_config(seed=1234, chunk_size=100, **ov),
                      device='cpu').get_arrays(inst)
    quiet = Simulator(default_config(seed=1234, chunk_size=100,
                                     **dict(ov, enable_noise=False)),
                      device='cpu').get_arrays(inst)
    return noisy, quiet


def strax_valid(rr, lo, hi):
    assert np.all(np.diff(rr['time']) >= 0)
    for ch in np.unique(rr['channel']):
        assert np.all(np.diff(rr['time'][rr['channel'] == ch]) >= 0), ch
    assert np.all((rr['channel'] >= lo) & (rr['channel'] < hi))
    assert np.all((rr['length'] > 0) & (rr['length'] <= 110))
    np.testing.assert_array_equal(
        rr['length'], np.minimum(110, rr['pulse_length']
                                 - 110 * rr['record_i'].astype(np.int64)))
    j = np.arange(110)[None, :]
    assert np.all(rr['data'][j >= rr['length'][:, None]] == 0)
    assert rr['data'].min() >= 0


def test_he_full_grid_slice_records(slice_runs):
    for out in slice_runs:
        rr, he = out['raw_records'], out['raw_records_he']
        assert len(rr) > 1000 and len(he) > 500
        assert len(out['raw_records_aqmon']) == 0
        strax_valid(rr, 0, C)
        strax_valid(he, HE_LO, HE_HI)
        n_top = int((rr['channel'] < N_TOP).sum())
        assert abs(len(he) - n_top) <= 0.05 * n_top
        types = out['truth']['type']
        assert (types == 1).sum() == (types == 2).sum() == N_EVENTS


def he_copies_tpc(out):
    """Every HE record equals the TPC record of channel - 500 (time,
    length, pulse_length, record_i, data), and the HE records are exactly
    those of the top array."""
    rr, he = out['raw_records'], out['raw_records_he']
    top = rr[rr['channel'] < N_TOP]
    key = ('time', 'channel', 'record_i')
    a = np.sort(top, order=key)
    shifted = he.copy()
    shifted['channel'] -= HE_LO
    b = np.sort(shifted, order=key)
    assert len(a) == len(b) > 500
    assert a.tobytes() == b.tobytes()


def test_he_records_copy_tpc_records_without_noise(slice_runs):
    he_copies_tpc(slice_runs[1])


def test_jax_he_records_copy_tpc_records_without_noise(aux_dir):
    ov = dict(he_full_grid_overrides(aux_dir), enable_noise=False)
    out = JaxSimulator(jax_default_config(seed=1234, chunk_size=100, **ov)
                       ).get_arrays(_make_inst(N_EVENTS, 2000, 300))
    he_copies_tpc(out)
    assert len(out['raw_records_aqmon']) == 0


@pytest.mark.parametrize('extra', [{}, dict(enable_noise=True,
                                            enable_pmt_afterpulses=True,
                                            enable_electron_afterpulses=True)],
                         ids=['default', 'realistic'])
def test_default_factor_keeps_the_slim_grid(extra):
    """At the default factor 0.05 (integer 0) and the TPC-wide synthetic
    bank, the default and realistic configurations take the slim grid of
    494 rows, and forcing the full grid adds no record: its HE rows hold
    only baseline and its sum row is 0."""
    c = default_config(**extra)
    p, k = build_params(c, load_config(c), 'cpu'), build_constants(c)
    assert k.high_energy_deamp_int == 0 and not full_grid(p, k)
    t, ch, gain, pieces = arena(3, 2, 700)
    args = [torch.from_numpy(x) for x in (t, ch, gain, pieces)]
    nix = torch.tensor([77, 99_000], dtype=torch.int32)
    slim = gather_digitize(p, k, *args, nix, n_samples=T, max_intervals=K)
    wide = gather_digitize(p, k, *args, nix, n_samples=T, max_intervals=K,
                           full=True)
    assert slim['data'].shape == (2, C, T)
    assert wide['data'].shape == (2, C_ALL, T)
    assert torch.equal(wide['data'][:, :C], slim['data'])
    he_in = wide['has'][:, HE_LO:HE_HI, None] & (
        torch.arange(T) >= wide['left_all'][:, HE_LO:HE_HI, None]) & (
        torch.arange(T) <= wide['right_all'][:, HE_LO:HE_HI, None])
    assert torch.all(wide['data'][:, HE_LO:HE_HI][he_in] == 16000)
    assert not wide['data'][:, SUM_CH].any()
    rs = pack_records(slim['data'], slim['left_all'], slim['starts'],
                      slim['ends'], slim['counts'])
    rw = pack_records(wide['data'], wide['left_all'], wide['starts'],
                      wide['ends'], wide['counts'])
    assert len(rs[1]) > 100
    for a, b in zip(rs, rw):
        assert torch.equal(a, b)


@pytest.mark.parametrize('factor,n_windows', [(0.05, 2), (1.0, 1)])
def test_window_framing(factor, n_windows):
    """Two pulses 50 us apart: one flush group (gap < right_raw_extension),
    sub-split at the gap with the factor's integer at 0, one window with
    the HE copies live (wfsim_tpu rawdata.py:1254-1259)."""
    rd = RawData(default_config(high_energy_deamplification_factor=factor),
                 device='cpu')
    rd._pulses = [_Pulse(0, 0, 10, 1_000_000, 1_001_000, 0),
                  _Pulse(0, 10, 10, 1_050_000, 1_051_000, 0)]
    wins = rd._windows()
    assert len(wins) == n_windows
    assert [w['flush'] for w in wins] == [True] + [False] * (n_windows - 1)
