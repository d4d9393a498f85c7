"""The hand-written CUDA kernels of wfsim_tpu_torch against their plain
PyTorch twins, on the card.  Every test skips without a CUDA device.

Run on a machine with the card (tests/conftest.py imports JAX, which the
port's machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bitwise — each kernel adds, compares and copies exactly what
its twin does, in the same order.
"""
import math

import numpy as np
import pytest
import torch

from wfsim_tpu_torch import _build
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.ops.waveform import superpose_adc, superpose_adc_ref
from wfsim_tpu_torch.ops.zle import zle_all_channels, zle_all_channels_ref
from wfsim_tpu_torch.pipeline.digitize import (gather_digitize, pack_records,
                                               pack_records_ref,
                                               window_photons)
from wfsim_tpu_torch.resources import load_config

from .ap_inputs import ap_tables, photon_set
from .test_torch_ap_diffuse_redesign import (
    AP_CASES, DIFFUSE_CASES, ap_args, ap_setup, diffuse_args, diffuse_case,
    diffuse_constants, diffuse_normals)
from .test_torch_garfield_redesign import (GARFIELD_CASES, garfield_case)
from .test_torch_garfield_redesign import torch_args as garfield_torch_args
from .test_torch_lumi_summaries_redesign import (
    LUMI_CASES, SUMMARY_CASES, lumi_case, sequential_rows_np, summary_case)
from .test_torch_photon_times_redesign import (
    PHOTON_CASES, electron_args, gasgap_args, photon_args, photon_case,
    tiled_np)
from .test_torch_s1_delays_redesign import (S1_DELAY_CASES, custom_case,
                                            nest_case)
from .test_torch_s1_times_redesign import CASES as S1_TIME_CASES
from .test_torch_s1_times_redesign import MODELS as S1_TIME_MODELS
from .test_torch_s1_times_redesign import s1_case
from .test_torch_round_order import (ORDER_CASES, any_case,
                                     long_round_case)
from .test_torch_record_arena import (DT, ROW_CASES, SPLITS,
                                      digitized_rounds, photon_buffers,
                                      PULSE_STARTS, row_case, torch_parts)
from .test_torch_pmt_truth_order import (
    SECOND_PASS, TRUTH_CASES, emulate_per_pmt, emulate_row_truth,
    photon_terms, truth_case)
from .test_torch_window_rows import WINDOW_CASES, window_case
from .test_torch_zle_pack_redesign import (ZLE_PACK_CASES, pack_args,
                                           zle_args, zle_pack_case)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernels have no CPU mode)')
    return torch.device('cuda:0')


@pytest.fixture(scope='module')
def setup(dev):
    c = default_config()
    return c, build_params(c, load_config(c), dev), build_constants(c)


def arena(seed, n_win, n_ch, T, per_win, dev):
    rng = np.random.default_rng(seed)
    n = n_win * per_win
    t = rng.integers(0, T * 10 + 300, n).astype(np.int32)   # some past the grid
    ch = rng.integers(-1, n_ch, n).astype(np.int32)
    g = rng.uniform(1e5, 8e6, n).astype(np.float32)
    pieces = np.zeros((n_win, 2, 3), np.int64)
    for w in range(n_win):
        pieces[w, 0] = (w * per_win, per_win // 2, 0)
        pieces[w, 1] = (w * per_win + per_win // 2, per_win - per_win // 2, 7)
    return [torch.as_tensor(a, device=dev) for a in (t, ch, g)], \
        torch.as_tensor(pieces, device=dev)


@pytest.mark.parametrize('T', [512, 1000, 2048])
def test_kernels_match_twins(setup, dev, T):
    c, params, const = setup
    (t, ch, g), pieces = arena(T, 5, 60, T, 3000, dev)
    ph = window_photons(const, t, ch, g, pieces, n_samples=T)
    args = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
            ph['ch_left'], ph['ch_right'], ph['has'])
    kw = dict(current_2_adc=const.current_2_adc,
              baseline=const.digitizer_reference_baseline, n_samples=T)
    grid = superpose_adc(*args, **kw)
    assert torch.equal(grid, superpose_adc_ref(*args, **kw))

    C = const.n_tpc_pmts
    zthr = params.zle_thresholds[:C].repeat(5).contiguous()
    zargs = (grid, zthr, ph['ch_left'], ph['ch_right'], ph['has'])
    for K in (4, 64):
        zkw = dict(holdoff=101, trigger_window=50, max_intervals=K)
        zk, zr = zle_all_channels(*zargs, **zkw), zle_all_channels_ref(*zargs, **zkw)
        for a, b in zip(zk, zr):
            assert torch.equal(a, b)
        pargs = (grid.reshape(5, C, T), ph['ch_left'].reshape(5, C),
                 zk[0].reshape(5, C, K), zk[1].reshape(5, C, K),
                 zk[2].reshape(5, C))
        for a, b in zip(pack_records(*pargs), pack_records_ref(*pargs)):
            assert torch.equal(a, b)


def test_gather_digitize_card_matches_cpu(setup, dev):
    c, params, const = setup
    (t, ch, g), pieces = arena(9, 3, 494, 1024, 5000, dev)
    params_cpu = build_params(c, load_config(c), 'cpu')
    out = []
    for p, d in ((params, dev), (params_cpu, torch.device('cpu'))):
        r = gather_digitize(p, const, t.to(d), ch.to(d), g.to(d),
                            pieces.to(d), n_samples=1024, max_intervals=64)
        out.append([x.cpu() for x in pack_records(
            r['data'], r['left_all'], r['starts'], r['ends'], r['counts'])])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_wrappers_count_launches_and_check_inputs(setup, dev):
    c, params, const = setup
    k = _build.KERNELS['wfsim_superpose_adc']
    before = k.launches
    one = torch.ones(1, dtype=torch.int32, device=dev)
    args = [torch.tensor([5], dtype=torch.int32, device=dev),
            torch.ones(1, device=dev), torch.tensor([0, 1], dtype=torch.int32,
                                                    device=dev),
            params.templates, 0 * one, one, torch.ones(1, dtype=torch.bool,
                                                       device=dev)]
    kw = dict(current_2_adc=1.0, baseline=16000, n_samples=16)
    superpose_adc(*args, **kw)
    assert k.launches == before + 1
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError):
        superpose_adc(*bad, **kw)
    bad = list(args)
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(TypeError):
        superpose_adc(*bad, **kw)
    assert k.launches == before + 1


# ---------------------------------------------------------------------------
# K17: the arena gather and channel extents (window_rows.cu)


def window_rows_check(const, t, ch, g, pieces, T):
    """window_photons on the card (given the host table) bitwise
    window_photons_ref on the card, one launch, no host sync, one slot of
    ``t`` a photon of the table; returns the kernel's outputs."""
    from wfsim_tpu_torch.pipeline.digitize import window_photons_ref
    k = _build.KERNELS['wfsim_window_rows']
    p = pieces.cpu().numpy() if isinstance(pieces, torch.Tensor) else pieces
    n = int(p[:, :, 1].sum())
    before = k.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = window_photons(const, t, ch, g, p, n_samples=T)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert k.launches == before + 1
    ref = window_photons_ref(const, t, ch, g, p, n_samples=T)
    for key in ('t', 'gain', 'row_ptr', 'ch_left', 'ch_right', 'has'):
        assert got[key].dtype == ref[key].dtype, key
        assert torch.equal(got[key], ref[key]), key
    assert got['t'].shape == (n,)
    return got


@pytest.mark.parametrize('T', [512, 1000, 2048])
def test_window_rows_matches_twin(setup, dev, T):
    c, params, const = setup
    (t, ch, g), pieces = arena(T, 5, 60, T, 3000, dev)
    ph = window_rows_check(const, t, ch, g, pieces, T)
    assert int(ph['row_ptr'][-1]) < t.shape[0]       # channel -1 dropped


@pytest.mark.parametrize('name', WINDOW_CASES)
def test_window_rows_cases(setup, dev, name):
    c, params, const = setup
    t, ch, g, pieces, T = window_case(name)
    window_rows_check(const, *(torch.as_tensor(a, device=dev)
                               for a in (t, ch, g)), pieces, T)


def test_window_rows_long_window_and_wide_batch(setup, dev):
    """One window of 10^6 photons in five pieces (123 segments), and a
    batch of 128 windows of 3,000 photons on 494 channels."""
    c, params, const = setup
    rng = np.random.default_rng(5)
    n = 1_000_000
    t = torch.as_tensor(rng.integers(0, 20_000, n + 10).astype(np.int32),
                        device=dev)
    ch = torch.as_tensor(rng.integers(-1, 494, n + 10).astype(np.int32),
                         device=dev)
    g = torch.as_tensor(rng.uniform(1e5, 8e6, n + 10).astype(np.float32),
                        device=dev)
    cuts = [0, 1, 300_000, 300_007, 750_000, n]
    pieces = np.zeros((1, 6, 3), np.int64)
    for i in range(5):
        pieces[0, i] = (10 + cuts[i], cuts[i + 1] - cuts[i], 40 * i)
    ph = window_rows_check(const, t, ch, g, pieces, 2048)
    assert int((ph['row_ptr'][1:] - ph['row_ptr'][:-1]).max()) > 1900
    (t, ch, g), pieces = arena(128, 128, 494, 2048, 3000, dev)
    window_rows_check(const, t, ch, g, pieces, 2048)


@pytest.mark.parametrize('detector', ['XENONnT', 'XENON1T'])
def test_window_rows_full_grid_configs(dev, detector):
    """The constants of the full-grid configurations (factor 1: the
    XENONnT grid, and XENON1T's 248 TPC channels)."""
    c = default_config(detector=detector,
                       high_energy_deamplification_factor=1.0)
    const = build_constants(c)
    C = const.n_tpc_pmts
    (t, ch, g), pieces = arena(17, 16, C, 2048, 4600, dev)
    ph = window_rows_check(const, t, ch, g, pieces, 2048)
    assert ph['has'].shape == (16 * C,)


@pytest.mark.parametrize('C', [1, 127, 1023])
def test_window_rows_odd_channel_counts(setup, dev, C):
    """An odd channel count: the place pass's staged (time, gain) pairs
    start on an 8-byte boundary whatever C is."""
    import dataclasses
    c, params, const = setup
    const = dataclasses.replace(const, n_tpc_pmts=C)
    (t, ch, g), pieces = arena(C, 24, C, 2048, 9000, dev)
    window_rows_check(const, t, ch, g, pieces, 2048)


def test_window_rows_drops_channels_past_c(setup, dev):
    """Photons whose channel is C or more are dropped on the card as in
    the twin, as photons of channel -1 are: bitwise the twin, and equal
    to the outputs with those channels set to -1."""
    c, params, const = setup
    C = const.n_tpc_pmts
    t, ch, g, pieces, T = window_case('pieces')
    used = np.flatnonzero(ch >= 0)[::5]
    bad, minus = ch.copy(), ch.copy()
    bad[used] = C + np.arange(len(used)) % 3 * 500
    minus[used] = -1
    got, ref = (window_rows_check(const, *(torch.as_tensor(a, device=dev)
                                           for a in (t, x, g)), pieces, T)
                for x in (bad, minus))
    for key in ('t', 'gain', 'row_ptr', 'ch_left', 'ch_right', 'has'):
        assert torch.equal(got[key], ref[key]), key


# ---------------------------------------------------------------------------
# realistic configuration: noise-fused superpose_adc and the afterpulse
# kernels


@pytest.fixture(scope='module')
def realistic(dev):
    c = default_config(enable_noise=True, enable_pmt_afterpulses=True,
                       photon_ap_cdfs=ap_tables())
    params = build_params(c, load_config(c), dev)
    return c, params, build_constants(c)


@pytest.mark.parametrize('T,wrap', [(512, False), (2048, True)])
def test_noise_superpose_matches_twin(realistic, dev, T, wrap):
    c, params, const = realistic
    (t, ch, g), pieces = arena(T + 1, 4, 494, T, 4000, dev)
    ph = window_photons(const, t, ch, g, pieces, n_samples=T)
    L = params.noise_bank.shape[1]
    nix = torch.tensor([L - T // 3, L - 1, 5, L // 2] if wrap
                       else [0, 17, 999, L // 2], dtype=torch.int32, device=dev)
    kw = dict(current_2_adc=const.current_2_adc,
              baseline=const.digitizer_reference_baseline, n_samples=T,
              noise_bank=params.noise_bank, noise_ix=nix, n_channels=494)
    args = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
            ph['ch_left'], ph['ch_right'], ph['has'])
    assert torch.equal(superpose_adc(*args, **kw),
                       superpose_adc_ref(*args, **kw))


def test_noisy_gather_digitize_card_matches_cpu(realistic, dev):
    c, params, const = realistic
    (t, ch, g), pieces = arena(11, 3, 494, 1024, 5000, dev)
    nix = torch.tensor([3, 50_000, 99_500], dtype=torch.int32)
    params_cpu = build_params(c, load_config(c), 'cpu')
    out = []
    for p, d in ((params, dev), (params_cpu, torch.device('cpu'))):
        r = gather_digitize(p, const, t.to(d), ch.to(d), g.to(d),
                            pieces.to(d), nix.to(d), n_samples=1024,
                            max_intervals=64)
        out.append([x.cpu() for x in pack_records(
            r['data'], r['left_all'], r['starts'], r['ends'], r['counts'])])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize('seed', [0, 1])
def test_pmt_afterpulse_kernels_match_twins(realistic, dev, seed):
    """The whole generator (select, rows, emit), with a uniform element so
    both branches of emit run, bitwise against its twin on the card and on
    the CPU; each entry launched once."""
    from wfsim_tpu_torch.models import afterpulse as ap
    c, params, const = realistic
    n = 200_000
    ph = {k: torch.as_tensor(v, device=dev)
          for k, v in photon_set(seed, n).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    draws = ap.pmt_ap_draws(gen, params.pmt_ap_delay_cdf.shape[0], n, dev)
    ks = [_build.KERNELS[k] for k in ('wfsim_pmt_ap_select',
                                      'wfsim_pmt_ap_rows',
                                      'wfsim_pmt_ap_emit')]
    before = [k.launches for k in ks]
    out, info = ap.pmt_afterpulse_photons(params, const, ph, draws,
                                          n_truth_rows=8)
    assert [k.launches for k in ks] == [b + 1 for b in before]
    ref, info_r = ap.pmt_afterpulse_photons_ref(params, const, ph, draws,
                                                n_truth_rows=8)
    assert info['total'] == info_r['total'] > 0
    for key in out:
        assert torch.equal(out[key], ref[key]), key
    for key in ('counts', 't_min', 't_max'):
        assert torch.equal(info[key], info_r[key]), key
    params_c = build_params(c, load_config(c), 'cpu')
    cpu, info_c = ap.pmt_afterpulse_photons(
        params_c, const, {k: v.cpu() for k, v in ph.items()},
        {k: v.cpu() for k, v in draws.items()}, n_truth_rows=8)
    for key in out:
        assert torch.equal(out[key].cpu(), cpu[key]), key


def test_photon_summaries_kernel_matches_twin(dev):
    from wfsim_tpu_torch.models import afterpulse as ap
    ph = {k: torch.as_tensor(v, device=dev)
          for k, v in photon_set(7, 100_000).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    u = ap.summary_draws(gen, 10, dev)
    a = ap.photon_summaries(ph, u, n_inst=10)
    b = ap.photon_summaries_ref(ph, u, n_inst=10)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the physics kernels: channel draw, luminescence tables, time passes, PMT
# response (the float64 raw-area sums and the moments within rtol 1e-12, the
# rest bitwise)


def _same(a, b, rtol_keys=()):
    if not isinstance(a, dict):
        a, b = dict(enumerate(a)), dict(enumerate(b))
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if k in rtol_keys:
            torch.testing.assert_close(x, y, rtol=1e-12, atol=0)
        else:
            assert torch.equal(x, y), k


FLOAT_TRUTH = ('raw_area', 'raw_area_trigger', 'raw_area_bottom',
               'raw_area_trigger_bottom', 't_mean_offset', 't_sigma',
               'photon_t_mean_offset', 'photon_t_sigma',
               'electron_t_mean_offset', 'electron_t_sigma')


def _sync_free(fn):
    """``fn()`` under set_sync_debug_mode('error'): a wrapper that syncs
    the host with the card raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')


@pytest.mark.parametrize('skewed', [False, True])
def test_channel_draw_matches_twins(dev, skewed):
    """Rows of up to 3,000 photons, or (skewed) one row of 10^6 among
    them, empty rows and rows without mass: bitwise against the twins on
    the card and on the CPU, one launch, no host sync."""
    from wfsim_tpu_torch.ops.randsample import channel_draw, channel_draw_ref
    rng = np.random.default_rng(21)
    I, C = 37, 494
    pat = (rng.random((I, C)) * (rng.random((I, C)) > 0.2)).astype(np.float32)
    pat[5] = 0.0                                   # a row without mass
    pat[:, 17] = 0.0                               # a channel never drawn
    counts = rng.integers(0, 3000, I)
    counts[3] = 0
    if skewed:
        counts[11] = 1_000_000
        counts[[0, I - 1]] = 0
    edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
    u = rng.random(int(counts.sum())).astype(np.float32)
    u[::991] = 0.0
    u[7::991] = np.float32(1 - 2 ** -24)
    args = [torch.as_tensor(pat), edges, torch.as_tensor(u)]
    cpu = channel_draw(*args)
    card_args = [a.to(dev) for a in args]
    k = _build.KERNELS['wfsim_channel_draw']
    before = k.launches
    card = _sync_free(lambda: channel_draw(*card_args))
    assert k.launches == before + 1
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(card, channel_draw_ref(*card_args))


def test_lumi_tables_match_twins(setup, dev):
    from wfsim_tpu_torch.models.s2 import (luminescence_tables,
                                           luminescence_tables_ref)
    _c, _params, const = setup
    card = luminescence_tables(const, 9, dev)
    assert torch.equal(card.cpu(), luminescence_tables_ref(const, 9, 'cpu'))
    assert torch.equal(card, luminescence_tables_ref(const, 9, dev))


def test_time_passes_match_twins(setup, dev):
    from wfsim_tpu_torch.models import s1, s2
    _c, _params, const = setup
    rng = np.random.default_rng(22)
    I = 23
    n_e = rng.integers(0, 400, I)
    n_ph = rng.integers(0, 30, int(n_e.sum()))
    e_edges = np.concatenate([[0], np.cumsum(n_e)])
    e_ph_edges = np.concatenate([[0], np.cumsum(n_ph)])
    E, N = int(e_edges[-1]), int(e_ph_edges[-1])

    def f(n):
        return rng.random(n).astype(np.float32)

    time_ = rng.integers(0, 10 ** 8, I).astype(np.int32)
    row = np.sort(rng.integers(0, 9, I)).astype(np.int64)
    kw1 = dict(decay_time=const.s1_decay_time,
               decay_spread=const.s1_decay_spread)
    a1 = [time_, e_edges, row, f(E), rng.normal(size=E).astype(np.float32)]
    kwe = dict(trapping=const.electron_trapping_time)
    ae = [time_, e_edges, rng.uniform(0, 2e5, I).astype(np.float32),
          rng.uniform(0, 300, I).astype(np.float32), f(E),
          rng.normal(size=E).astype(np.float32), row]
    for fn, ref, args, kw in ((s1.s1_photon_times, s1.s1_photon_times_ref,
                               a1, kw1),
                              (s2.s2_electron_times,
                               s2.s2_electron_times_ref, ae, kwe)):
        cpu = [torch.as_tensor(a) for a in args]
        card = [a.to(dev) for a in cpu]
        _same(fn(*card, **kw), fn(*cpu, **kw))
        _same(fn(*card, **kw), ref(*card, **kw))
    e_t = s2.s2_electron_times(*[torch.as_tensor(a) for a in ae], **kwe)[0]
    inv = s2.luminescence_tables(const, I, 'cpu')
    u = f(N)
    u[:3] = np.nextafter(np.float32(1), np.float32(0))  # u*(Q-1) -> Q-1
    ap = [inv, torch.as_tensor(e_edges), torch.as_tensor(e_ph_edges), e_t,
          torch.as_tensor(row), torch.as_tensor(u), torch.as_tensor(f(N)),
          torch.as_tensor(f(N) * 300),
          torch.as_tensor(rng.normal(size=N).astype(np.float32))]
    kwp = dict(singlet_fraction=const.singlet_fraction_gas,
               t_singlet=const.singlet_lifetime_gas,
               t_triplet=const.triplet_lifetime_gas, time_spread=25.0)
    card = [a.to(dev) for a in ap]
    _same(s2.s2_photon_times(*card, **kwp), s2.s2_photon_times(*ap, **kwp))
    _same(s2.s2_photon_times(*card, **kwp),
          s2.s2_photon_times_ref(*card, **kwp))
    card[-1] = None                                 # zero_delay: no spread
    ap[-1] = None
    _same(s2.s2_photon_times(*card, **kwp), s2.s2_photon_times(*ap, **kwp))


def test_pmt_kernels_match_twins(setup, dev):
    from wfsim_tpu_torch.models import pmt
    c, params, const = setup
    params_cpu = build_params(c, load_config(c), 'cpu')
    rng = np.random.default_rng(23)
    n, rows = 60_000, 11
    counts = rng.multinomial(n, np.ones(rows) / rows)
    counts[4] = 0                                   # an empty row
    n = int(counts.sum())
    ch = rng.integers(-1, 494, n).astype(np.int32)
    args = dict(t=rng.integers(-50, 3_000_000, n).astype(np.int32), ch=ch,
                valid=ch >= 0, truth_row=np.repeat(np.arange(rows), counts))
    gen = torch.Generator().manual_seed(23)
    draws = pmt.pmt_draws(gen, n, 'cpu')
    edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
    cpu = {k: torch.as_tensor(v) for k, v in args.items()}
    card = {k: v.to(dev) for k, v in cpu.items()}
    kw = dict(n_truth_rows=rows)
    ph_c, tr_c = pmt.pmt_response(params_cpu, const, *cpu.values(), draws,
                                  row_edges=edges, **kw)
    ph_d, tr_d = pmt.pmt_response(params, const, *card.values(),
                                  {k: v.to(dev) for k, v in draws.items()},
                                  row_edges=edges.to(dev), **kw)
    _same(ph_d, ph_c)
    _same(tr_d, tr_c, FLOAT_TRUTH)
    assert int(tr_d['photon_t_min'][4]) == 2 ** 31 - 1
    st_c = pmt.photon_time_stats(ph_c['t'], None, cpu['truth_row'], rows,
                                 edges)
    st_d = pmt.photon_time_stats(ph_d['t'], None, card['truth_row'], rows,
                                 edges.to(dev))
    _same(st_d, st_c, FLOAT_TRUTH)


@pytest.mark.parametrize('kind', ['s1', 's2'])
def test_photon_pass_card_matches_cpu(setup, dev, kind):
    """One S1 or S2 batch of the bench workload (32 events): draws made on
    the card, the pass through the kernels on the card and through the
    twins on the CPU."""
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models import s1, s2
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    c, params, const = setup
    rd = RawData(c, device=dev)
    inst = bench_instructions(32, 2000, 300)
    idx = np.flatnonzero(inst['type'] == (1 if kind == 's1' else 2))
    x, _base, _rows, n_rows = rd.batch_inputs(inst, idx, kind)
    draw, fn = ((s1.s1_draws, s1.s1_photon_pass) if kind == 's1'
                else (s2.s2_draws, s2.s2_photon_pass))
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    d = draw(params, const, x, gen)

    def cpu(v):
        if isinstance(v, dict):
            return {k: cpu(w) for k, w in v.items()}
        return v.cpu() if isinstance(v, torch.Tensor) else v

    ph_d, tr_d, req_d = fn(params, const, x, d, n_truth_rows=n_rows)
    ph_c, tr_c, req_c = fn(build_params(c, load_config(c), 'cpu'), const,
                           cpu(x), cpu(d), n_truth_rows=n_rows)
    _same(ph_d, ph_c)
    _same(tr_d, tr_c, FLOAT_TRUTH)
    assert torch.equal(req_d.cpu(), req_c)


@pytest.mark.parametrize('shape,out_dim,n', [
    ((7,), 1, 1000), ((30, 30), 494, 1000), ((5, 6, 4), 1, 1000),
    ((30, 30), 494, 512), ((50, 50, 100), 1, 1_570_000),
    ((50, 100), 1, 1_570_000)])
def test_grid_lookup_matches_twins(dev, shape, out_dim, n):
    """Bitwise against the twins on the card and on the CPU, one launch,
    no host sync; 512 points is the S2 batch's instruction width on the
    pattern map, 1.57 M the photon width of the optical splines (a 2-d
    (z, u) map for S1)."""
    from wfsim_tpu_torch.ops.interp import GridMap, grid_lookup_ref
    rng = np.random.default_rng(25)
    d = len(shape)
    gmap = GridMap(torch.as_tensor(rng.random(shape + (out_dim,),
                                              dtype=np.float32)),
                   torch.as_tensor(-rng.random(d, dtype=np.float32) * 40),
                   torch.as_tensor(rng.random(d, dtype=np.float32) * 40 + 1))
    pts = torch.as_tensor(rng.uniform(-50, 50, (n, d)).astype(np.float32))
    cpu = gmap(pts)
    card_map = gmap.to(dev)
    card_pts = pts.to(dev)
    k = _build.KERNELS['wfsim_grid_lookup']
    before = k.launches
    card = _sync_free(lambda: card_map(card_pts))
    assert k.launches == before + 1
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(card, grid_lookup_ref(card_map.values, card_map.lows,
                                             card_map.highs, card_pts))


@pytest.mark.parametrize('kind', ['s1', 's2'])
def test_detector_physics_pass_card_matches_cpu(dev, tmp_path, kind):
    """One S1 or S2 batch of the detector_physics workload (32 events)
    through the NEST, gas-gap, diffused-pattern and map-lookup kernels on
    the card and through the twins on the CPU, from the same draws."""
    from wfsim_tpu_torch.config import detector_physics_overrides
    from wfsim_tpu_torch.interface import detector_physics_instructions
    from wfsim_tpu_torch.models import s1, s2
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    from wfsim_tpu_torch.resources.synthetic import write_pattern_map
    c = default_config(**detector_physics_overrides(
        write_pattern_map(tmp_path / 'pmap.json', 3)))
    rd = RawData(c, device=dev)
    inst = detector_physics_instructions(32, 2000, 300)
    idx = np.flatnonzero(inst['type'] == (1 if kind == 's1' else 2))
    x, _base, _rows, n_rows = rd.batch_inputs(inst, idx, kind)
    draw, fn, entries = (
        (s1.s1_draws, s1.s1_photon_pass, ('wfsim_nest_delays',))
        if kind == 's1' else
        (s2.s2_draws, s2.s2_photon_pass, ('wfsim_pattern_diffuse',
                                          'wfsim_lumi_gasgap_times')))
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    d = draw(rd.params, rd.const, x, gen)

    def cpu(v):
        if isinstance(v, dict):
            return {k: cpu(w) for k, w in v.items()}
        return v.cpu() if isinstance(v, torch.Tensor) else v

    before = {e: _build.KERNELS[e].launches for e in entries}
    ph_d, tr_d, req_d = fn(rd.params, rd.const, x, d, n_truth_rows=n_rows)
    assert all(_build.KERNELS[e].launches > before[e] for e in entries)
    ph_c, tr_c, req_c = fn(build_params(c, load_config(c), 'cpu'), rd.const,
                           cpu(x), cpu(d), n_truth_rows=n_rows)
    _same(ph_d, ph_c)
    _same(tr_d, tr_c, FLOAT_TRUTH)
    assert torch.equal(req_d.cpu(), req_c)


# ---------------------------------------------------------------------------
# the full XENONnT digitizer grid: superpose_adc_full and ZLE in its
# nonneg mode


def full_grid_inputs(seed, dev, neg_frac, neg_scale, T=1024, B=4, per=1500):
    """B windows of ``per`` photons over the 494 TPC channels, window 2
    without photons; a fraction ``neg_frac`` of negative gains (positive
    ADC) of ``neg_scale`` times the usual magnitude; an 801-wide bank."""
    from wfsim_tpu_torch.resources.synthetic import synthetic_noise
    c = default_config()
    const = build_constants(c)
    params = build_params(c, load_config(c), dev)
    rng = np.random.default_rng(seed)
    n = B * per
    t = rng.integers(1500, T * 10 - 3000, n).astype(np.int32)
    ch = rng.integers(0, 494, n).astype(np.int32)
    g = rng.uniform(1e6, 3e6, n)
    g = np.where(rng.random(n) < neg_frac, -neg_scale * g, g).astype(np.float32)
    pieces = np.zeros((B, 1, 3), np.int64)
    for w in range(B):
        pieces[w, 0] = (w * per, 0 if w == 2 else per, 0)
    ph = window_photons(const, *(torch.as_tensor(a, device=dev)
                                 for a in (t, ch, g)),
                        pieces, n_samples=T)
    bank = torch.as_tensor(np.ascontiguousarray(
        synthetic_noise(801, 5000, seed=3).T.astype(np.int16)), device=dev)
    nix = torch.tensor([5000 - 100, 0, 17, 2500], dtype=torch.int32,
                       device=dev)
    args = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
            ph['ch_left'], ph['ch_right'], ph['has'])
    kw = dict(current_2_adc=const.current_2_adc,
              baseline=const.digitizer_reference_baseline, n_samples=T,
              n_channels=494, n_channels_total=801, n_top=253, he_start=500,
              sum_channel=800, noise_bank=bank, noise_ix=nix)
    return args, kw, ph


@pytest.mark.parametrize('deamp,neg_frac', [(1, 0.0), (2000, 0.1)],
                         ids=['factor 1', 'int16 wrap'])
def test_full_grid_kernel_matches_twin(dev, deamp, neg_frac):
    from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                              superpose_adc_full_ref)
    args, kw, ph = full_grid_inputs(deamp, dev, neg_frac, 0.2)
    kw['deamp'] = deamp
    k = _build.KERNELS['wfsim_superpose_adc_full']
    before = k.launches
    out = superpose_adc_full(*args, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    ref = superpose_adc_full_ref(*args, **kw)
    assert out.shape == (4, 801, 1024) and torch.equal(out, ref)
    assert not out[2].any()                      # the window without photons
    assert out[:, 500:753].any() and out[:, 800].any()
    if deamp == 2000:
        assert (out[:, 500:753] < 0).any()                   # HE rows wrapped
        assert (out[:, 800].to(torch.int64) % 2000 != 0).any()   # sum wrapped

    # ZLE of the full grid (nonneg mode) against its twin
    from wfsim_tpu_torch.pipeline.digitize import full_grid_rows
    B, R, T = out.shape
    const = build_constants(default_config())
    rows = [full_grid_rows(ph[k].reshape(B, 494), const).reshape(-1)
            for k in ('ch_left', 'ch_right', 'has')]
    zthr = torch.full((B * R,), 15984, dtype=torch.int32, device=dev)
    zkw = dict(holdoff=101, trigger_window=50, max_intervals=32, nonneg=True)
    zargs = (out.reshape(B * R, T), zthr, *rows)
    for a, b in zip(zle_all_channels(*zargs, **zkw),
                    zle_all_channels_ref(*zargs, **zkw)):
        assert torch.equal(a, b)


def test_full_grid_kernel_raises_past_16_bits(dev):
    from wfsim_tpu_torch.ops.waveform import superpose_adc_full
    args, kw, _ = full_grid_inputs(5, dev, 0.2, 1.0)
    with pytest.raises(OverflowError):
        superpose_adc_full(*args, deamp=2000, **kw)


def test_full_grid_gather_digitize_card_matches_cpu(dev):
    """The full grid through gather_digitize and pack_records on the card
    and on the CPU twins, 801-wide bank, factor 1: records bitwise."""
    import dataclasses
    from wfsim_tpu_torch.resources.synthetic import synthetic_noise
    c = default_config(enable_noise=True)
    const = dataclasses.replace(build_constants(c), high_energy_deamp_int=1)
    bank = np.ascontiguousarray(
        synthetic_noise(801, 20_000, seed=4).T.astype(np.int16))
    (t, ch, g), pieces = arena(13, 3, 494, 1024, 5000, dev)
    nix = torch.tensor([3, 10_000, 19_500], dtype=torch.int32)
    out = []
    for d in (dev, torch.device('cpu')):
        p = dataclasses.replace(build_params(c, load_config(c), d),
                                noise_bank=torch.as_tensor(bank, device=d))
        r = gather_digitize(p, const, t.to(d), ch.to(d), g.to(d),
                            pieces.to(d), nix.to(d), n_samples=1024,
                            max_intervals=64)
        assert r['data'].shape == (3, 801, 1024)
        out.append([x.cpu() for x in pack_records(
            r['data'], r['left_all'], r['starts'], r['ends'], r['counts'])])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert ((out[0][1][:, 1] >= 500) & (out[0][1][:, 1] < 753)).sum() > 100


# ---------------------------------------------------------------------------
# the timing models: custom S1 delays (K15) and garfield luminescence (K13c)


@pytest.mark.parametrize('counts', [[], [0], [0, 5000, 3, 0],
                                    [1] * 7 + [0] + [40_000] * 5]
                         + list(S1_DELAY_CASES))
def test_custom_delays_match_twin(dev, counts):
    """Every recoil class (ER 7 and 8, NR, alpha, LED), recombination
    uniforms of 0, an empty batch and instructions without photons; the
    cases of tests/test_torch_s1_delays_redesign.py (the bench batch, one
    alpha instruction of 10^5 photons, runs of empty instructions, tiles
    of hundreds of instructions, edges on tile edges); one launch a call,
    no read-back."""
    from wfsim_tpu_torch.models import s1
    const = build_constants(default_config(s1_model_type='custom'))
    if isinstance(counts, str):
        cls, edges, draws = custom_case(counts)
        n = int(edges[-1])
        draws = {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}
        cls = torch.as_tensor(cls, device=dev)
    else:
        rng = np.random.default_rng(len(counts))
        counts = np.asarray(counts, np.int64)
        n = int(counts.sum())
        recoil = np.resize(np.array([7, 0, 6, 20, 8], np.int32), len(counts))
        draws = {k: torch.as_tensor(
            (rng.exponential(1.0, n) if k.startswith('exp')
             else rng.random(n)).astype(np.float32), device=dev)
            for k in s1.CUSTOM_DRAWS}
        draws['u_reco'][::50] = 0.0
        cls = s1.recoil_class(torch.as_tensor(recoil, device=dev))
        edges = np.concatenate([[0], np.cumsum(counts)])
    edges = torch.as_tensor(edges, device=dev)
    k = _build.KERNELS['wfsim_s1_custom_delays']
    before = k.launches
    got = _sync_free(lambda: s1.custom_delays(cls, edges, draws, const=const))
    assert k.launches == before + (1 if n else 0)
    want = s1.custom_delays_ref(cls, edges, draws, const=const)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    cpu = s1.custom_delays_ref(cls.cpu(), edges.cpu(),
                               {k: v.cpu() for k, v in draws.items()},
                               const=const)
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.parametrize('name', S1_DELAY_CASES)
def test_nest_delays_match_twin(dev, name):
    """wfsim_nest_delays on the cases of
    tests/test_torch_s1_delays_redesign.py: an empty batch and one without
    instructions, instructions with 0 photons, one alpha instruction of
    10^5 photons past the energy grid, tiles of hundreds of instructions,
    edges on tile edges; u of 0, 1 - 2^-24 and 1 (k1 clamped); fields and
    energies on and past both grid ends.  Bitwise the twin on the CPU and
    on the card, the same bits on a second call, one launch a call, no
    read-back."""
    from wfsim_tpu_torch.models import s1
    cpu = [torch.as_tensor(a) for a in nest_case(name)]
    want = s1.nest_delays_ref(*cpu)
    card = [a.to(dev) for a in cpu]
    assert torch.equal(s1.nest_delays_ref(*card).cpu(), want)
    k = _build.KERNELS['wfsim_nest_delays']
    before = k.launches
    _twice_bitwise(lambda: _sync_free(lambda: s1.nest_delays(*card)), want)
    assert k.launches == before + (2 if want.shape[0] else 0)


def _s1_times_on_card(dev, args, n):
    """wfsim_s1_photon_times on ``args`` (tensors on the card, or None):
    no read-back, one launch a call (none without photons), bitwise the
    twin on the CPU, the same bits on a second call."""
    from wfsim_tpu_torch.models import s1
    const = build_constants(default_config())
    kw = dict(decay_time=const.s1_decay_time,
              decay_spread=const.s1_decay_spread)
    want = s1.s1_photon_times_ref(
        *(None if a is None else a.cpu() for a in args), **kw)
    k = _build.KERNELS['wfsim_s1_photon_times']
    before = k.launches

    def call():
        n_sync, out, lines = _syncs(s1.s1_photon_times, *args, n_photons=n,
                                    **kw)
        assert n_sync == 0, lines
        return out
    _twice_bitwise(call, want)
    assert k.launches == before + (2 if n else 0)


@pytest.mark.parametrize('model', list(S1_TIME_MODELS))
@pytest.mark.parametrize('name', S1_TIME_CASES)
def test_s1_photon_times_match_twin(dev, name, model):
    """wfsim_s1_photon_times on the cases of
    tests/test_torch_s1_times_redesign.py (the bench batch, instructions of
    0, HEAD-1, HEAD, HEAD+1, HEAD+TILE and 10^5 photons, 3,000 instructions,
    empty instructions on tile boundaries, the S1_SKEWED batch, only empty
    instructions) under every timing model (simple, custom, nest,
    custom+nest and none)."""
    args = s1_case(name, model)
    _s1_times_on_card(dev, [None if a is None else torch.as_tensor(
        a, device=dev) for a in args], int(args[1][-1]))


@pytest.mark.parametrize('offset', [1, 3, 4])
def test_s1_photon_times_on_views(dev, offset):
    """Every draw and delay a view starting ``offset`` floats into its
    buffer (1 and 3: unaligned, the scalar loads; 4: 16-byte aligned) on
    the case with instructions of 10^5 and HEAD + 1 photons, all three
    models at once."""
    rng = np.random.default_rng(offset)
    time, edges, row, exp, nrm, _n, _c = s1_case('sizes', 'simple')
    n = int(edges[-1])

    def view(x):
        buf = torch.empty(n + offset, dtype=torch.float32, device=dev)
        buf[offset:] = torch.as_tensor(x, device=dev)
        return buf[offset:]
    nest = rng.exponential(40.0, n).astype(np.float32)
    custom = rng.uniform(0, 1000.0, n).astype(np.float32)
    _s1_times_on_card(dev, [torch.as_tensor(time, device=dev),
                            torch.as_tensor(edges, device=dev),
                            torch.as_tensor(row, device=dev), view(exp),
                            view(nrm), view(nest), view(custom)], n)


@pytest.mark.parametrize('confine,counts', [
    (-1.0, []), (-1.0, [0]), (-1.0, [300] * 64 + [0] + [7]),
    (0.1, [1000] * 20 + [0])] + [(None, name) for name in GARFIELD_CASES])
def test_garfield_times_match_twin(dev, confine, counts):
    """Both wire-distance modes, positions on both sides of the wires, an
    empty batch and instructions without photons; the cases of
    tests/test_torch_garfield_redesign.py (the bench batch in both modes,
    one instruction of 10^6 photons, runs of empty instructions, tiles of
    hundreds of instructions, ties in x_axis and in |d - x_r|); one launch
    a call, no read-back."""
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.models.params import table_mean_int
    from wfsim_tpu_torch.resources.synthetic import synthetic_garfield_table
    if confine is None:
        args, u_wire, kw = garfield_torch_args(garfield_case(counts))
        args = [a.to(dev) for a in args]
        u_wire = None if u_wire is None else u_wire.to(dev)
        n = int(args[4].shape[0])
    else:
        tbl = synthetic_garfield_table(3)
        rng = np.random.default_rng(len(counts))
        counts = np.asarray(counts, np.int64)
        n_i, n = len(counts), int(counts.sum())
        xy = rng.uniform(-60, 60, (n_i, 2)).astype(np.float32)
        args = [torch.as_tensor(a, device=dev) for a in (
            tbl['t'], tbl['x'], xy, np.concatenate([[0], np.cumsum(counts)]),
            rng.integers(0, tbl['t'].shape[1], n))]
        u_wire = (torch.as_tensor(rng.random(n_i).astype(np.float32),
                                  device=dev) if confine > 0 else None)
        kw = dict(avgt=table_mean_int(tbl['t']), tilt=np.pi / 4, pitch=0.5,
                  confine=confine)
    k = _build.KERNELS['wfsim_lumi_garfield_times']
    before = k.launches
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = s2.lumi_garfield_times(*args, u_wire, **kw)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert k.launches == before + (1 if n else 0)
    assert torch.equal(got, s2.lumi_garfield_times_ref(*args, u_wire, **kw))


@pytest.mark.parametrize('kind', ['s1', 's2'])
def test_timing_models_pass_card_matches_cpu(dev, tmp_path, kind):
    """One S1 or S2 batch of the timing_models workload (32 events, all
    four recoil classes) through the custom-delay and garfield kernels on
    the card and through the twins on the CPU, from the same draws."""
    from wfsim_tpu_torch.config import timing_models_overrides
    from wfsim_tpu_torch.interface import timing_models_instructions
    from wfsim_tpu_torch.models import s1, s2
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    from wfsim_tpu_torch.resources.synthetic import write_garfield_table
    c = default_config(**timing_models_overrides(
        write_garfield_table(tmp_path / 'garfield.npz', 3)))
    rd = RawData(c, device=dev)
    inst = timing_models_instructions(32, 2000, 300)
    idx = np.flatnonzero(inst['type'] == (1 if kind == 's1' else 2))
    x, _base, _rows, n_rows = rd.batch_inputs(inst, idx, kind)
    draw, fn, entry = (
        (s1.s1_draws, s1.s1_photon_pass, 'wfsim_s1_custom_delays')
        if kind == 's1' else
        (s2.s2_draws, s2.s2_photon_pass, 'wfsim_lumi_garfield_times'))
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    d = draw(rd.params, rd.const, x, gen)

    def cpu(v):
        if isinstance(v, dict):
            return {k: cpu(w) for k, w in v.items()}
        return v.cpu() if isinstance(v, torch.Tensor) else v

    before = _build.KERNELS[entry].launches
    ph_d, tr_d, req_d = fn(rd.params, rd.const, x, d, n_truth_rows=n_rows)
    assert _build.KERNELS[entry].launches == before + 1
    ph_c, tr_c, req_c = fn(build_params(c, load_config(c), 'cpu'), rd.const,
                           cpu(x), cpu(d), n_truth_rows=n_rows)
    _same(ph_d, ph_c)
    _same(tr_d, tr_c, FLOAT_TRUTH)
    assert torch.equal(req_d.cpu(), req_c)


# ---------------------------------------------------------------------------
# per-PMT truth (K16) and the XENON1T grid without HE rows


PER_PMT_AREAS = ('raw_area_per_pmt', 'raw_area_trigger_per_pmt')


@pytest.mark.parametrize('detector', ['XENONnT', 'XENON1T'])
def test_per_pmt_kernel_matches_twin(dev, detector):
    """The per-PMT entry against its twin on the card and on the CPU: an
    empty row, photons without a channel and invalid ones; counts bitwise,
    areas within rtol 1e-12 (exact fixed-point sums against the twin's
    float64 ones); then pmt_response with per-PMT truth, card against
    CPU."""
    from wfsim_tpu_torch.models import pmt
    c = default_config(detector=detector, per_pmt_truth=True)
    const = build_constants(c)
    params = build_params(c, load_config(c), dev)
    params_cpu = build_params(c, load_config(c), 'cpu')
    C = int(params.gains.shape[0])
    rng = np.random.default_rng(31)
    rows = 13
    counts = rng.multinomial(40_000, np.ones(rows) / rows)
    counts[4] = 0                                   # an empty row
    n = int(counts.sum())
    ch = rng.integers(-1, C, n).astype(np.int32)
    ph = dict(t=rng.integers(-50, 3_000_000, n).astype(np.int32), ch=ch,
              gain=rng.uniform(1e5, 8e6, n).astype(np.float32),
              is_dpe=rng.random(n) < 0.219,
              valid=(ch >= 0) & (rng.random(n) > 0.02),
              truth_row=np.repeat(np.arange(rows), counts))
    edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
    ph_c = {k: torch.as_tensor(v) for k, v in ph.items()}
    ph_d = {k: v.to(dev) for k, v in ph_c.items()}
    k = _build.KERNELS['wfsim_pmt_row_truth_per_pmt']
    before = k.launches
    out = pmt.pulse_truth_per_pmt(params, const, ph_d, edges.to(dev))
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert out['n_photon_per_pmt'].shape == (rows, C)
    _same(out, pmt.pulse_truth_per_pmt_ref(params, const, ph_d,
                                           edges.to(dev)), PER_PMT_AREAS)
    _same(out, pmt.pulse_truth_per_pmt_ref(params_cpu, const, ph_c, edges),
          PER_PMT_AREAS)
    assert not any(v[4].any() for v in out.values())
    assert int(out['n_photon_per_pmt'].sum()) == int(ph['valid'].sum())

    gen = torch.Generator().manual_seed(31)
    draws = pmt.pmt_draws(gen, n, 'cpu')
    args = [ph_c[k] for k in ('t', 'ch', 'valid', 'truth_row')]
    kw = dict(n_truth_rows=rows)
    ph_cc, tr_c = pmt.pmt_response(params_cpu, const, *args, draws,
                                   row_edges=edges, **kw)
    ph_dd, tr_d = pmt.pmt_response(
        params, const, *[a.to(dev) for a in args],
        {k: v.to(dev) for k, v in draws.items()}, row_edges=edges.to(dev),
        **kw)
    _same(ph_dd, ph_cc)
    _same(tr_d, tr_c, FLOAT_TRUTH + PER_PMT_AREAS)
    assert not any(k.endswith('_bottom') for k in tr_d)


def no_he_inputs(seed, dev, bank_width, T=1024, B=4, per=1500):
    """B XENON1T windows of ``per`` photons over the 248 TPC channels,
    window 2 without photons; a bank of ``bank_width`` columns (None: noise
    off)."""
    from wfsim_tpu_torch.resources.synthetic import synthetic_noise
    c = default_config(detector='XENON1T')
    const = build_constants(c)
    params = build_params(c, load_config(c), dev)
    rng = np.random.default_rng(seed)
    n = B * per
    t = rng.integers(1500, T * 10 - 3000, n).astype(np.int32)
    ch = rng.integers(0, 248, n).astype(np.int32)
    g = rng.uniform(1e6, 3e6, n).astype(np.float32)
    pieces = np.zeros((B, 1, 3), np.int64)
    for w in range(B):
        pieces[w, 0] = (w * per, 0 if w == 2 else per, 0)
    ph = window_photons(const, *(torch.as_tensor(a, device=dev)
                                 for a in (t, ch, g)),
                        pieces, n_samples=T)
    bank = nix = None
    if bank_width:
        bank = torch.as_tensor(np.ascontiguousarray(synthetic_noise(
            bank_width, 5000, seed=3).T.astype(np.int16)), device=dev)
        nix = torch.tensor([5000 - 100, 0, 17, 2500], dtype=torch.int32,
                           device=dev)
    args = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
            ph['ch_left'], ph['ch_right'], ph['has'])
    kw = dict(current_2_adc=const.current_2_adc,
              baseline=const.digitizer_reference_baseline, n_samples=T,
              n_channels=248, n_channels_total=801, n_top=127, he_start=None,
              sum_channel=None, deamp=1, noise_bank=bank, noise_ix=nix)
    return args, kw


@pytest.mark.parametrize('bank_width', [None, 248, 801])
def test_no_he_grid_kernel_matches_twin(dev, bank_width):
    from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                              superpose_adc_full_ref)
    args, kw = no_he_inputs(bank_width or 0, dev, bank_width)
    k = _build.KERNELS['wfsim_superpose_adc_full']
    before = k.launches
    out = superpose_adc_full(*args, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert out.shape == (4, 801, 1024)
    assert torch.equal(out, superpose_adc_full_ref(*args, **kw))
    assert not out[2].any()                      # the window without photons
    assert out[:, :248].any() and not out[:, 248:].any()


def test_no_he_gather_digitize_card_matches_cpu(dev):
    """XENON1T at factor 1 through gather_digitize and pack_records on the
    card and on the CPU twins, with noise: records bitwise, channels below
    248, the same as on the slim grid."""
    c = default_config(detector='XENON1T', enable_noise=True,
                       high_energy_deamplification_factor=1.0)
    const = build_constants(c)
    (t, ch, g), pieces = arena(17, 3, 248, 1024, 4000, dev)
    nix = torch.tensor([3, 10_000, 19_500], dtype=torch.int32)
    out = []
    for d, full in ((dev, True), (torch.device('cpu'), True), (dev, False)):
        p = build_params(c, load_config(c), d)
        r = gather_digitize(p, const, t.to(d), ch.to(d), g.to(d),
                            pieces.to(d), nix.to(d), n_samples=1024,
                            max_intervals=64, full=full)
        assert r['data'].shape == (3, 801 if full else 248, 1024)
        out.append([x.cpu() for x in pack_records(
            r['data'], r['left_all'], r['starts'], r['ends'], r['counts'])])
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)
    assert len(out[0][1]) > 100 and int(out[0][1][:, 1].max()) < 248


@pytest.mark.parametrize('n_blocks,n_ch_shards,T,skew', [
    (1, 1, 2048, 0), (2, 2, 1000, 0), (3, 4, 512, 0), (2, 1, 2 ** 16, 10 ** 5),
    (4, 2, 1025, 20_000), (4, 1, 1000, 20_000), (2, 2, 2 ** 16, 0)])
def test_superpose_block_matches_twin(setup, dev, n_blocks, n_ch_shards, T,
                                      skew):
    """K14's channel block: int32 ADC and the bottom-array sum rows of
    every channel block, bitwise the twin's, with launches counted; with
    ``skew``, channel 300 of the last block holds that many more photons
    spread over the grid (one row of 10^5 at T = 2^16); grids of 2^16,
    1,000 and 1,025 samples, 1 to 4 blocks of 1, 2 or 4 channel shards."""
    from wfsim_tpu_torch.ops.waveform import (superpose_block,
                                              superpose_block_ref)
    from wfsim_tpu_torch.parallel.sharding import block_photons
    _c, params, const = setup
    C, n_top = const.n_tpc_pmts, const.n_top_pmts
    rng = np.random.default_rng(T + n_blocks)
    n = 20_000 * n_blocks
    ph = dict(t=rng.integers(-500, T * 10 + 500, n + skew).astype(np.int32),
              ch=rng.integers(-1, C, n + skew).astype(np.int32),
              gain=rng.uniform(1e5, 8e6, n + skew).astype(np.float32),
              valid=rng.random(n + skew) < 0.97)
    block = rng.integers(0, n_blocks, n + skew)
    ph['ch'][n:] = 300
    ph['valid'][n:] = True
    block[n:] = n_blocks - 1
    ph = {k: torch.as_tensor(v, device=dev) for k, v in ph.items()}
    block = torch.as_tensor(block, device=dev)
    C_loc = -(-C // n_ch_shards)
    k = _build.KERNELS['wfsim_superpose_block']
    for j in range(n_ch_shards):
        bp = block_photons(ph, block, n_blocks=n_blocks, ch_block=j * C_loc,
                           n_channels=C_loc, n_samples=T,
                           sample_duration=const.sample_duration)
        args = (bp['t'], bp['gain'], bp['row_ptr'], params.templates)
        kw = dict(n_channels=C_loc, ch_block=j * C_loc, n_top=n_top, n_tpc=C,
                  current_2_adc=const.current_2_adc, n_samples=T)
        before = k.launches
        adc, sums = superpose_block(*args, **kw)
        assert k.launches == before + 1
        adc_r, sums_r = superpose_block_ref(*args, **kw)
        assert adc.shape == (n_blocks * C_loc, T) and sums.shape == (n_blocks, T)
        assert torch.equal(adc, adc_r) and torch.equal(sums, sums_r)
        assert bool(adc.any())
        if skew and j * C_loc <= 300 < (j + 1) * C_loc:
            row = (n_blocks - 1) * C_loc + 300 - j * C_loc
            assert int(bp['row_ptr'][row + 1] - bp['row_ptr'][row]) > skew // 2


def test_superpose_block_two_streams_and_negative_time(setup, dev):
    """Two calls on two streams at once give the twin's bits (the sum rows
    and status word are per call); a negative photon time raises after the
    launch, as on the CPU."""
    from wfsim_tpu_torch.ops.waveform import (superpose_block,
                                              superpose_block_ref)
    _c, params, const = setup
    rng = np.random.default_rng(8)
    counts = rng.poisson(300, 2 * 494)
    counts[700] = 50_000
    n = int(counts.sum())
    t = torch.as_tensor(rng.integers(0, 2 ** 16 * 10, n).astype(np.int32),
                        device=dev)
    gain = torch.as_tensor(rng.uniform(1e5, 8e6, n).astype(np.float32),
                           device=dev)
    row_ptr = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)])
                              .astype(np.int32), device=dev)
    kw = dict(n_channels=494, ch_block=0, n_top=const.n_top_pmts,
              n_tpc=const.n_tpc_pmts, current_2_adc=const.current_2_adc,
              n_samples=2 ** 16)
    want = superpose_block_ref(t, gain, row_ptr, params.templates, **kw)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got_side = superpose_block(t, gain, row_ptr, params.templates, **kw)
    got = superpose_block(t, gain, row_ptr, params.templates, **kw)
    torch.cuda.synchronize(dev)
    for out in (got, got_side):
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    bad = t.clone()
    bad[12_345] = -3
    with pytest.raises(ValueError, match='>= 0'):
        superpose_block(bad, gain, row_ptr, params.templates, **kw)


# ---------------------------------------------------------------------------
# the row-tile superposition kernels (slim, slim with noise, full grid
# with and without HE rows) on the batches of tests/superpose_cases.py, and
# the status word their wrappers read back once a call


def superpose_inputs(case, grid, dev):
    """(wrapper, twin, args, kw) of one grid of tests/
    test_torch_superpose_redesign.py's GRIDS on one case."""
    from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                              superpose_adc_full_ref)
    from wfsim_tpu_torch.resources.synthetic import synthetic_noise
    from .superpose_cases import superpose_case
    t, ch, g, pieces, T = superpose_case(case)
    det, width, factor = dict(
        slim=('XENONnT', None, 0), slim_noise=('XENONnT', 494, 0),
        full=('XENONnT', 801, 1), no_he=('XENON1T', 248, 1))[grid]
    c = default_config(detector=det)
    const = build_constants(c)
    params = build_params(c, load_config(c), dev)
    ph = window_photons(const, *(torch.as_tensor(a, device=dev)
                                 for a in (t, ch, g)),
                        pieces, n_samples=T)
    args = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
            ph['ch_left'], ph['ch_right'], ph['has'])
    C = const.n_tpc_pmts
    kw = dict(current_2_adc=const.current_2_adc,
              baseline=const.digitizer_reference_baseline, n_samples=T)
    if width:
        kw.update(n_channels=C, noise_ix=torch.tensor(
            [2700, 100, 1400][:len(pieces)], dtype=torch.int32, device=dev),
            noise_bank=torch.as_tensor(np.ascontiguousarray(synthetic_noise(
                width, 3000, seed=9).T.astype(np.int16)), device=dev))
    if grid in ('slim', 'slim_noise'):
        return superpose_adc, superpose_adc_ref, args, kw
    he = grid == 'full'
    kw.update(n_channels=C, n_channels_total=const.n_channels_total,
              n_top=const.n_top_pmts,
              he_start=const.he_channel_start if he else None,
              sum_channel=const.sum_signal_channel if he else None,
              deamp=factor)
    return superpose_adc_full, superpose_adc_full_ref, args, kw


@pytest.mark.parametrize('grid', ['slim', 'slim_noise', 'full', 'no_he'])
@pytest.mark.parametrize('case', [
    'T = 8195', 'a row with 3,000 photons', 'photons at the window end',
    'an empty row and an empty window', 'left not a multiple of 8'])
def test_superpose_kernels_match_twins_on_cases(dev, case, grid):
    fn, twin, args, kw = superpose_inputs(case, grid, dev)
    k = _build.KERNELS['wfsim_superpose_adc' if fn is superpose_adc
                       else 'wfsim_superpose_adc_full']
    before = k.launches
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    ref = twin(*args, **kw)
    assert out.shape == ref.shape and torch.equal(out, ref)
    assert out.any()


@pytest.mark.parametrize('shape', [(5, 13), (10, 40)])
def test_superpose_kernels_other_template_banks(dev, shape):
    """A template bank other than 10 x 22 (the kernels' runtime-sized
    instance; 40 taps: more than a warp's 32 lanes)."""
    fn, twin, args, kw = superpose_inputs('T = 8195', 'full', dev)
    fn_s, twin_s, args_s, kw_s = superpose_inputs('T = 8195', 'slim_noise',
                                                  dev)
    tmpl = torch.as_tensor(np.random.default_rng(7).uniform(
        0.0, 0.02, shape).astype(np.float32), device=dev)
    for f, tw, a, k in ((fn, twin, args, kw), (fn_s, twin_s, args_s, kw_s)):
        a = list(a)
        a[3] = tmpl
        assert torch.equal(f(*a, **k), tw(*a, **k))


def _syncs(fn, *args, errors=(), **kw):
    """Host syncs of one call ``fn(*args, **kw)``: (their count, its result
    or the error of a type in ``errors`` it raised, the lines that synced),
    from the warnings of ``set_sync_debug_mode('warn')``, one a
    synchronizing operation."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn(*args, **kw)
        except errors as e:
            out = e
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    lines = [f'{w.filename}:{w.lineno}' for w in caught
             if 'called a synchronizing CUDA operation' in str(w.message)]
    return len(lines), out, lines


def test_superpose_status_word_raises(dev):
    """A negative photon time, a noise offset out of range and an HE value
    past 16 bits each raise after the kernel's launch, from one read-back
    of the status word (one synchronizing operation a call)."""
    from wfsim_tpu_torch.ops.waveform import superpose_adc_full
    errors = (ValueError, OverflowError)

    for grid in ('slim_noise', 'full'):
        fn, _twin, args, kw = superpose_inputs('photons at the window end',
                                               grid, dev)
        n, out, lines = _syncs(fn, *args, errors=errors, **kw)
        assert n == 1 and torch.is_tensor(out), lines
        t = args[0].clone()
        t[5] = -3
        n, err, lines = _syncs(fn, t, *args[1:], errors=errors, **kw)
        assert n == 1, lines
        assert isinstance(err, ValueError) and '>= 0' in str(err)
        nix = kw['noise_ix'].clone()
        nix[1] = 2 ** 30
        n, err, lines = _syncs(fn, *args, errors=errors,
                               **dict(kw, noise_ix=nix))
        assert n == 1, lines
        assert isinstance(err, ValueError) and '2^30' in str(err)
        # no samples: no launch, the same checks from one read-back
        for targs, tkw, msg in (((t, *args[1:]), kw, '>= 0'),
                                (args, dict(kw, noise_ix=nix), '2^30')):
            n, err, lines = _syncs(fn, *targs, errors=errors,
                                   **dict(tkw, n_samples=0))
            assert n == 1, lines
            assert isinstance(err, ValueError) and msg in str(err)
        n, out, lines = _syncs(fn, *args, errors=errors,
                               **dict(kw, n_samples=0))
        assert n == 1 and torch.is_tensor(out), lines
    # full grid: |adc x factor| past 2^16 in the HE rows
    args, kw, _ph = full_grid_inputs(5, dev, 0.2, 1.0)
    n, err, lines = _syncs(superpose_adc_full, *args, errors=errors,
                           **dict(kw, deamp=2000))
    assert n == 1 and isinstance(err, OverflowError), lines


# ---------------------------------------------------------------------------
# the record rows (K4r) on the cases of tests/test_torch_record_arena.py,
# the record arena's copies, and rounds of a fixed pulse set


@pytest.mark.parametrize('name', ROW_CASES)
def test_round_records_match_twin(dev, name):
    """A round's sorted raw_record rows on the card bitwise those of the
    CPU twin, per-window counts equal; record_rows reads nothing back and
    launches once (none without records); round_records reads back once
    (the counts)."""
    from wfsim_tpu_torch.pipeline.digitize import round_records, record_rows
    case = row_case(name)
    kw = dict(dt=DT, n_samples=case['n_samples'], n_rows=case['n_rows'])
    k = _build.KERNELS['wfsim_record_rows']
    before = k.launches
    n, (rows, counts), lines = _syncs(round_records, torch_parts(case, dev),
                                      case['win_left'], **kw)
    assert n == 1, lines
    ref, counts_ref = round_records(torch_parts(case), case['win_left'], **kw)
    assert rows.shape == ref.shape
    assert rows.cpu().numpy().tobytes() == ref.numpy().tobytes()
    np.testing.assert_array_equal(counts, counts_ref)
    assert k.launches == before + (len(ref) > 0)
    if len(ref):
        data = torch.cat([d for _, d, _ in torch_parts(case, dev)])
        meta = torch.cat([m for _, _, m in torch_parts(case, dev)])
        win = torch.as_tensor(np.concatenate(
            [np.asarray(b, np.int32)[m[:, 0]] for b, _, m in case['parts']]),
            device=dev)
        wl = torch.as_tensor(case['win_left'], device=dev)
        perm = torch.randperm(len(ref), device=dev)
        n, out, lines = _syncs(record_rows, data, meta, win, wl, perm, DT)
        assert n == 0, lines
        assert torch.equal(out.cpu(), record_rows(
            data.cpu(), meta.cpu(), win.cpu(), wl.cpu(), perm.cpu(), DT))


def test_record_arena_copies_on_the_card(dev, monkeypatch):
    """Two rounds' rows copied on the copy stream through pinned staging
    into one arena base: bytes equal to the rows, both slices views of one
    base, each round's rows dropped at once (record_stream keeps them for
    the copy); a round past the base starts a new one."""
    from wfsim_tpu_torch.pipeline.arena import RecordArena
    from wfsim_tpu_torch.pipeline.digitize import round_records
    monkeypatch.setattr(RecordArena, 'chunk_rows', 0)
    want, copies = [], []
    arena = None
    for name in ('bench-like batches', 'one channel of many records',
                 'bench-like batches'):
        case = row_case(name)
        rows = round_records(torch_parts(case, dev), case['win_left'], dt=DT,
                             n_samples=case['n_samples'],
                             n_rows=case['n_rows'])[0]
        want.append(rows.cpu().numpy().tobytes())
        if arena is None:
            RecordArena.note_chunk(2 * len(rows) + 5000)
            arena = RecordArena()
        copies.append(arena.put(rows))
        del rows
        torch.empty(10 ** 8, dtype=torch.uint8, device=dev).fill_(7)
    got = [RecordArena.wait(c) for c in copies]
    assert [g.view(np.int16).tobytes() for g in got] == want
    assert got[0].base is got[1].base and got[2].base is not got[0].base
    assert np.shares_memory(got[0].base, got[1])


def test_rounds_on_the_card_match_the_cpu(dev):
    """The fixed pulse set digitized in three rounds on the card and on
    the CPU: every window's records bitwise equal; K4r launched once a
    round."""
    pulse_set = (PULSE_STARTS, photon_buffers())
    k = _build.KERNELS['wfsim_record_rows']
    before = k.launches
    _rd, card = digitized_rounds(pulse_set, SPLITS[2], device=dev)
    assert k.launches == before + sum(1 for r in card if r[1])
    _rd, cpu = digitized_rounds(pulse_set, SPLITS[2])
    assert len(card) == len(cpu)
    for (_p, wa, ra), (_q, wb, rb) in zip(card, cpu):
        assert [w['win_left'] for w in wa] == [w['win_left'] for w in wb]
        assert [r.tobytes() for r in ra] == [r.tobytes() for r in rb]


# ---------------------------------------------------------------------------
# the round ordering (round_order.cu) on the cases of
# tests/test_torch_round_order.py and tests/test_torch_record_arena.py


def round_order_check(case, dev):
    """round_order on the card: perm, win and counts bitwise the plain
    version's on the card (the packed-key sort), one launch and no host
    sync; round_records then bitwise the CPU's with one read-back a round
    (the counts).  Returns the card's counts."""
    from wfsim_tpu_torch.pipeline.digitize import (round_order,
                                                   round_order_ref,
                                                   round_records)
    kw = dict(n_samples=case['n_samples'], n_rows=case['n_rows'])
    k = _build.KERNELS['wfsim_round_order']
    before = k.launches
    n, o, lines = _syncs(round_order, torch_parts(case, dev),
                         case['win_left'], **kw)
    assert n == 0, lines
    assert k.launches == before + 1
    ref = round_order_ref(torch_parts(case, dev), case['win_left'], **kw)
    for key in ('perm', 'win', 'counts'):
        assert torch.equal(o[key], ref[key]), key
    rows_k = _build.KERNELS['wfsim_record_rows']
    before = rows_k.launches
    n, (rows, counts), lines = _syncs(round_records, torch_parts(case, dev),
                                      case['win_left'], dt=DT, **kw)
    assert n == 1, lines
    assert rows_k.launches == before + (len(rows) > 0)
    rows_c, counts_c = round_records(torch_parts(case), case['win_left'],
                                     dt=DT, **kw)
    assert rows.cpu().numpy().tobytes() == rows_c.numpy().tobytes()
    np.testing.assert_array_equal(counts, counts_c)
    return counts


@pytest.mark.parametrize('name', ORDER_CASES + ROW_CASES)
def test_round_order_matches_twin(dev, name):
    round_order_check(any_case(name), dev)


def test_round_with_a_window_of_1e5_records(dev):
    """A window of 100,282 records: 25 chunks of 4,096, each sorted and
    ranked against the window's other records on a block of its own."""
    counts = round_order_check(long_round_case(100_000), dev)
    assert counts.tolist()[1] >= 100_000


def test_round_order_checks(dev):
    """The card's ordering takes each round window in exactly one batch,
    and keys of (start, channel) in 32 bits; else it raises before a
    launch."""
    from wfsim_tpu_torch.pipeline.digitize import round_order
    case = any_case('several batches')
    kw = dict(n_samples=case['n_samples'], n_rows=case['n_rows'])
    k = _build.KERNELS['wfsim_round_order']
    before = k.launches
    parts = torch_parts(case, dev)
    parts[0] = (np.asarray(parts[0][0]) + 1, *parts[0][1:])
    with pytest.raises(ValueError, match='once'):
        round_order(parts, case['win_left'], **kw)
    with pytest.raises(OverflowError, match='32 bits'):
        round_order(torch_parts(case, dev), case['win_left'],
                    n_samples=2 ** 23, n_rows=2 ** 10)
    assert k.launches == before


def test_empty_round(dev):
    """A round of one window and no record: the ordering launches, the
    rows kernel does not, counts [0], one read-back."""
    case = long_round_case(100_000)
    case['parts'] = [(np.array([0]), np.zeros((0, 110), np.int16),
                      np.zeros((0, 6), np.int32))]
    case['win_left'] = case['win_left'][:1]
    assert round_order_check(case, dev).tolist() == [0]


# ---------------------------------------------------------------------------
# the warp-scan ZLE kernel and the row-planned record pack on the cases of
# tests/test_torch_zle_pack_redesign.py, with the read-backs a call


@pytest.mark.parametrize('name', ZLE_PACK_CASES)
def test_zle_pack_kernels_match_twins_on_cases(dev, name):
    """K3 reads nothing back and K4 once (its record total); both bitwise
    their twins, sentinel slots included; one launch of each entry (the
    copy none without records)."""
    case = zle_pack_case(name)
    args, kw = zle_args(case, dev)
    k3, k4a, k4b = (_build.KERNELS[k] for k in (
        'wfsim_zle_intervals', 'wfsim_pack_record_counts',
        'wfsim_pack_records'))
    before = k3.launches, k4a.launches, k4b.launches
    n3, zk, lines = _syncs(zle_all_channels, *args, **kw)
    assert n3 == 0, lines
    for a, b in zip(zk, zle_all_channels_ref(*args, **kw)):
        assert torch.equal(a, b)
    pargs = pack_args(case, zk, dev)
    n4, pk, lines = _syncs(pack_records, *pargs)
    assert n4 <= 1, lines
    pr = pack_records_ref(*pargs)
    for a, b in zip(pk, pr):
        assert a.shape == b.shape and torch.equal(a, b)
    n_rec = pr[0].shape[0]
    assert (n_rec == 0) == (name == 'a batch with no records')
    assert (k3.launches, k4a.launches, k4b.launches) == (
        before[0] + 1, before[1] + 1, before[2] + (n_rec > 0))


# ---------------------------------------------------------------------------
# the PMT-afterpulse generator without a sort (K11) and the diffused pattern
# with each electron's geometry once (K12b) on the cases of
# tests/test_torch_ap_diffuse_redesign.py, with the read-backs a call


@pytest.fixture(scope='module')
def ap_both(dev):
    """The three-element tables on the card and on the CPU."""
    c, params, const = ap_setup(dev)
    return params, build_params(c, load_config(c), 'cpu'), const


@pytest.mark.parametrize('name', AP_CASES)
def test_afterpulse_kernels_match_twins_on_cases(ap_both, dev, name):
    """K11 reads back once (its total and status word), bitwise its twin
    on the card and on the CPU; select and rows launch once, emit once
    when a slot is selected."""
    from wfsim_tpu_torch.models import afterpulse as ap
    params, params_c, const = ap_both
    ph, draws, n_rows = ap_args(name, params, dev)
    ks = [_build.KERNELS[k] for k in ('wfsim_pmt_ap_select',
                                      'wfsim_pmt_ap_rows',
                                      'wfsim_pmt_ap_emit')]
    before = [k.launches for k in ks]
    n, (out, info), lines = _syncs(ap.pmt_afterpulse_photons, params, const,
                                   ph, draws, n_truth_rows=n_rows)
    assert n == 1, lines
    total = info['total']
    assert [k.launches for k in ks] == [before[0] + 1, before[1] + 1,
                                        before[2] + (total > 0)]
    for ref, info_r in (
            ap.pmt_afterpulse_photons_ref(params, const, ph, draws,
                                          n_truth_rows=n_rows),
            ap.pmt_afterpulse_photons(
                params_c, const, {k: v.cpu() for k, v in ph.items()},
                {k: v.cpu() for k, v in draws.items()},
                n_truth_rows=n_rows)):
        assert info_r['total'] == total
        for key in out:
            assert out[key].dtype == ref[key].dtype
            assert torch.equal(out[key].cpu(), ref[key].cpu()), key
        for key in ('counts', 't_min', 't_max'):
            assert torch.equal(info[key].cpu(), info_r[key].cpu()), key
    assert (total == 0) == (name == 'no valid photon')


def test_afterpulse_rows_without_row_count_and_out_of_range(ap_both, dev):
    """Without ``n_truth_rows`` the wrapper reads the last row back too (two
    read-backs) and gives the twin's photons; a truth row at or past
    ``n_truth_rows`` raises after the one read-back."""
    from wfsim_tpu_torch.models import afterpulse as ap
    params, _params_c, const = ap_both
    ph, draws, n_rows = ap_args('a bench-like set', params, dev)
    n, (out, info), lines = _syncs(ap.pmt_afterpulse_photons, params, const,
                                   ph, draws)
    assert n == 2 and set(info) == {'total'}, lines
    ref, _ = ap.pmt_afterpulse_photons_ref(params, const, ph, draws)
    for key in out:
        assert torch.equal(out[key], ref[key]), key
    n, err, lines = _syncs(ap.pmt_afterpulse_photons, params, const, ph,
                           draws, errors=(ValueError,),
                           n_truth_rows=n_rows - 1)
    assert n == 1 and isinstance(err, ValueError), lines


@pytest.mark.parametrize('name', DIFFUSE_CASES)
def test_pattern_diffuse_kernel_matches_twins_on_cases(dev, name):
    """K12b reads nothing back, launches once, and is bitwise its twin on
    the card and on the CPU (the twin's float64 sums are exact here), with
    and without the chunk count."""
    from wfsim_tpu_torch.models import s2
    const = diffuse_constants()
    case = diffuse_case(name, const.tpc_radius)
    n_r, n_a = diffuse_normals(name, int(case['counts'].sum()))
    args = diffuse_args(case, const, n_r, n_a, dev)
    k = _build.KERNELS['wfsim_pattern_diffuse']
    before = k.launches
    n, out, lines = _syncs(s2.pattern_diffuse, *args)
    assert n == 0, lines
    assert k.launches == before + 1
    assert torch.equal(out, s2.pattern_diffuse_ref(*args))
    assert torch.equal(out.cpu(), s2.pattern_diffuse(
        *diffuse_args(case, const, n_r, n_a)))
    # the chunk count from the host, as the S2 pass passes it: the same
    # bits; one chunk short, the split instruction's row is NaN
    split = int(s2.diffuse_chunks(torch.as_tensor(case['counts'])))
    n, out2, lines = _syncs(s2.pattern_diffuse, *args, split)
    assert n == 0 and torch.equal(out2, out), lines
    if split:
        big = torch.as_tensor(case['counts'] > s2.DIFFUSE_CHUNK, device=dev)
        short = s2.pattern_diffuse(*args, split - 1)
        assert short[big].isnan().all()
        assert torch.equal(short[~big], out[~big])


# ---------------------------------------------------------------------------
# the luminescence tables by block scans (K6) and the photon summaries from
# prefix counts (K11 summaries) on the cases of
# tests/test_torch_lumi_summaries_redesign.py, with the read-backs a call


@pytest.mark.parametrize('name', LUMI_CASES)
def test_lumi_tables_kernel_matches_twins_on_cases(dev, name):
    """K6 launches once and reads nothing back, is bitwise its twin on the
    card and on the CPU, and counts on its sequential pass the rows of the
    exact-integer mirror."""
    from wfsim_tpu_torch.models import s2
    const, dG, n = lumi_case(name)
    gaps = None if dG is None else torch.as_tensor(dG, device=dev)
    s2.luminescence_tables(const, n, dev, gaps)     # the grids cached
    k = _build.KERNELS['wfsim_lumi_tables']
    count = s2.lumi_sequential_rows(dev)
    count.zero_()
    before = k.launches
    n_sync, out, lines = _syncs(s2.luminescence_tables, const, n, dev, gaps)
    assert n_sync == 0, lines
    assert k.launches == before + 1
    assert int(count) == int(sequential_rows_np(const, n, dG).sum())
    assert torch.equal(out, s2.luminescence_tables_ref(const, n, dev, gaps))
    assert torch.equal(out.cpu(), s2.luminescence_tables_ref(
        const, n, 'cpu', None if dG is None else torch.as_tensor(dG)))


@pytest.mark.parametrize('name', SUMMARY_CASES)
def test_photon_summaries_kernels_match_twins_on_cases(dev, name):
    """The summaries read nothing back, launch the valid-tiles and
    summaries kernels once each (neither without a photon) and are
    bitwise their twin on the card and on the CPU."""
    from wfsim_tpu_torch.models import afterpulse as ap
    ph, u, n_inst = summary_case(name)
    ph_d = {k: torch.as_tensor(v, device=dev) for k, v in ph.items()}
    u_d = torch.as_tensor(u, device=dev)
    ks = [_build.KERNELS[k] for k in ('wfsim_ap_valid_tiles',
                                      'wfsim_ap_photon_summaries')]
    before = [k.launches for k in ks]
    n_sync, out, lines = _syncs(ap.photon_summaries, ph_d, u_d,
                                n_inst=n_inst)
    assert n_sync == 0, lines
    ran = len(ph['t']) > 0
    assert [k.launches for k in ks] == [b + ran for b in before]
    for ref in (ap.photon_summaries_ref(ph_d, u_d, n_inst=n_inst),
                ap.photon_summaries({k: torch.as_tensor(v)
                                     for k, v in ph.items()},
                                    torch.as_tensor(u), n_inst=n_inst)):
        for x, y in zip(out, ref):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


# ---------------------------------------------------------------------------
# the truth kernels (K8 row truth, K16) on the cases of
# tests/test_torch_pmt_truth_order.py


def _bits(a, b, what):
    """a (card) and b bitwise equal, dict by dict (floats by their bits)."""
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = a[k].cpu(), torch.as_tensor(np.asarray(b[k]))
        assert x.shape == y.shape, (what, k)
        y = y.to(x.dtype)
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y), (what, k)


def _truth_setup(detector, dev):
    c = default_config(detector=detector)
    return build_params(c, load_config(c), dev)


def _scratch_is_zero(dev):
    """The kernels' scratch buffers on ``dev`` (one per stream) are all
    zero."""
    torch.cuda.synchronize()
    bufs = [b for (d, _s), b in _build.SCRATCH.items() if d == dev]
    return bool(bufs) and not any(bool(b.any()) for b in bufs)


@pytest.mark.parametrize('name', TRUTH_CASES)
def test_row_truth_kernel_on_cases(dev, name):
    """wfsim_pmt_row_truth with channels and without (the electron-time
    call): bitwise the numpy emulation of its arithmetic, counts bitwise and
    floats within rtol 1e-12 of the twins, the same bits on a second call,
    one launch and no read-back a call, the second-pass counters moved by
    the case's rows, the scratch left zero."""
    from wfsim_tpu_torch.models import pmt
    params, const, ph, edges = truth_case(name)
    params_d = _truth_setup('XENONnT', dev)
    ph_d = {k: v.to(dev) for k, v in ph.items()}
    e_d = edges.to(dev)
    R = edges.shape[0] - 1
    terms = photon_terms(params, const, ph)
    k = _build.KERNELS['wfsim_pmt_row_truth']
    count = pmt.pmt_truth_second_pass(dev)
    count.zero_()
    before = k.launches
    out = _sync_free(lambda: pmt._row_truth(params_d, const, ph_d['t'],
                                            ph_d['valid'], e_d, ph=ph_d))
    again = pmt._row_truth(params_d, const, ph_d['t'], ph_d['valid'], e_d,
                           ph=ph_d)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    want, _rows = emulate_row_truth(ph['t'].numpy(), ph['valid'].numpy(),
                                    edges.numpy(), terms)
    _bits(out, want, 'emulation')
    _bits(again, {kk: v.cpu().numpy() for kk, v in out.items()}, 'again')
    twin = pmt.pulse_truth_ref(params, const, ph, edges)
    twin.update(pmt.photon_time_stats_ref(ph['t'], ph['valid'],
                                          ph['truth_row'], R, edges))
    _same(out, twin, FLOAT_TRUTH)
    m, a = SECOND_PASS[name]
    assert count.tolist() == [2 * m, 2 * a, 0]
    # the electron-time call: no channels, every element valid
    count.zero_()
    st = _sync_free(lambda: pmt._row_truth(None, None, ph_d['t'], None,
                                           e_d))
    want, _rows = emulate_row_truth(ph['t'].numpy(), None, edges.numpy())
    _bits(st, want, 'electron times')
    _same(st, pmt.photon_time_stats_ref(ph['t'], None, ph['truth_row'], R,
                                        edges), FLOAT_TRUTH)
    assert count.tolist() == [m, 0, 0]
    assert _scratch_is_zero(dev)


@pytest.mark.parametrize('detector', ['XENONnT', 'XENON1T'])
@pytest.mark.parametrize('name', TRUTH_CASES)
def test_per_pmt_kernel_on_cases(dev, name, detector):
    """wfsim_pmt_row_truth_per_pmt on 494 and 248 channels: bitwise the
    numpy emulation (exact fixed-point areas; photon order on the
    second-pass rows), counts bitwise and areas within rtol 1e-12 of the
    twin, the same bits on a second call, no read-back, the counter moved
    by the case's rows, the scratch left zero."""
    from wfsim_tpu_torch.models import pmt
    params, const, ph, edges = truth_case(name, detector)
    params_d = _truth_setup(detector, dev)
    C = int(params.gains.shape[0])
    ph_d = {k: v.to(dev) for k, v in ph.items()}
    e_d = edges.to(dev)
    count = pmt.pmt_truth_second_pass(dev)
    count.zero_()
    k = _build.KERNELS['wfsim_pmt_row_truth_per_pmt']
    before = k.launches
    out = _sync_free(lambda: pmt.pulse_truth_per_pmt(params_d, const, ph_d,
                                                     e_d))
    again = pmt.pulse_truth_per_pmt(params_d, const, ph_d, e_d)
    torch.cuda.synchronize()
    assert k.launches == before + 2
    want, _bad = emulate_per_pmt(photon_terms(params, const, ph),
                                 edges.numpy(), C)
    _bits(out, want, 'emulation')
    _bits(again, {kk: v.cpu().numpy() for kk, v in out.items()}, 'again')
    _same(out, pmt.pulse_truth_per_pmt_ref(params, const, ph, edges),
          PER_PMT_AREAS)
    assert count.tolist() == [0, 0, 2 * SECOND_PASS[name][1]]
    assert _scratch_is_zero(dev)


def test_truth_kernels_on_two_streams(dev):
    """Both truth kernels launched on two side streams with no wait
    between them, on the row of 10^6 (its pieces combine in the scratch):
    each stream keeps its own scratch buffer, every output is bitwise the
    default stream's, and every buffer is left zero."""
    from wfsim_tpu_torch.models import pmt
    params, const, ph, edges = truth_case('one row of 10^6')
    params_d = _truth_setup('XENONnT', dev)
    ph_d = {k: v.to(dev) for k, v in ph.items()}
    e_d = edges.to(dev)

    def both():
        out = pmt._row_truth(params_d, const, ph_d['t'], ph_d['valid'], e_d,
                             ph=ph_d)
        out.update(pmt.pulse_truth_per_pmt(params_d, const, ph_d, e_d))
        return out
    want = both()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    got = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(st):
            got.append(both())
    torch.cuda.synchronize()
    keys = {(dev, st.cuda_stream) for st in streams}
    assert keys <= set(_build.SCRATCH)
    assert len({_build.SCRATCH[k].data_ptr() for k in keys}) == 2
    for out in got:
        _bits(out, {k: v.cpu().numpy() for k, v in want.items()}, 'stream')
    assert _scratch_is_zero(dev)


# ---------------------------------------------------------------------------
# the gas-gap luminescence times (K13a) and the S2 electron and photon
# times (K9): flat tiles, no read-back


def _twice_bitwise(fn, want):
    """``fn()`` twice: both bitwise ``want`` (a tensor or a tuple)."""
    for _ in range(2):
        got = fn()
        if isinstance(want, torch.Tensor):
            got, want_t = (got,), (want,)
        else:
            want_t = want
        assert len(got) == len(want_t)
        for x, y in zip(got, want_t):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize('name', PHOTON_CASES)
def test_gasgap_kernel_on_cases(dev, name):
    """wfsim_lumi_gasgap_times: bitwise its twin on the CPU and on the card,
    the same bits on a second call, no host sync with the host bound
    given, one launch a call and the scratch (sums, tickets and the flag)
    left zero.  The bench case runs every instruction in an instruction
    block; the others also list one or more for the tile passes (the tile
    edges case with instruction edges on 4,096-photon boundaries, the many
    just past case every instruction, its tiles half again the grid)."""
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.models.params import gasgap_time_max
    c = photon_case(name)
    assert tiled_np(c['ph_edges'], c['n'], 8192).any() is not (
        name in ('bench', 'no electrons', 'electrons without photons',
                 'u = 1 - 2^-24'))
    cpu = gasgap_args(c)
    card = [a.to(dev) for a in cpu]
    want = s2.lumi_gasgap_times_ref(*cpu)
    assert torch.equal(s2.lumi_gasgap_times_ref(*card).cpu(), want)
    t_max = gasgap_time_max(c['gg_inv_cdf'], c['gaps'], c['gap'])
    kernel = _build.KERNELS['wfsim_lumi_gasgap_times']
    before = kernel.launches
    _twice_bitwise(lambda: s2.lumi_gasgap_times(*card, t_max=t_max), want)
    assert kernel.launches == before + 2
    assert torch.equal(_sync_free(lambda: s2.lumi_gasgap_times(
        *card, t_max=t_max)).cpu(), want)
    assert _scratch_is_zero(dev)


@pytest.mark.parametrize('name', PHOTON_CASES)
def test_s2_time_kernels_on_cases(dev, name):
    """wfsim_s2_photon_times in both luminescence modes and without the
    time spread, and wfsim_s2_electron_times: bitwise
    their twins on the CPU and on the card, the same bits on a second call,
    no host sync."""
    from wfsim_tpu_torch.models import s2
    c = photon_case(name)
    e_args, e_kw = electron_args(c)
    want = s2.s2_electron_times_ref(*e_args, **e_kw)
    e_card = [a.to(dev) for a in e_args]
    _twice_bitwise(lambda: s2.s2_electron_times(*e_card, **e_kw), want)
    _twice_bitwise(lambda: _sync_free(
        lambda: s2.s2_electron_times(*e_card, **e_kw)), want)
    for lum, spread in (('inv', True), ('t_lum', True), ('inv', False)):
        args, kw = photon_args(c, lum, spread)
        want = s2.s2_photon_times_ref(*args, **kw)
        card = [None if a is None else a.to(dev) for a in args]
        kw_d = dict(kw, t_lum=None if kw['t_lum'] is None
                    else kw['t_lum'].to(dev))
        _twice_bitwise(lambda: s2.s2_photon_times_ref(*card, **kw_d), want)
        _twice_bitwise(lambda: s2.s2_photon_times(*card, **kw_d), want)
        _twice_bitwise(lambda: _sync_free(
            lambda: s2.s2_photon_times(*card, **kw_d)), want)


@pytest.mark.parametrize('n_photons,fits', [(2100, True), (2200, False)])
@pytest.mark.parametrize('bound', [False, True])
def test_gasgap_range_check_on_the_card(dev, n_photons, fits, bound):
    """The cases of test_gasgap_mean_fixed_point_range on the card, with
    and without the host bound: 2,100 photons at 1 ms give the exact mean
    (every time 0), 2,200 raise OverflowError; with the bound, the fitting
    case reads nothing back."""
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.models.params import gasgap_time_max
    inv = torch.full((2, 16), 1e6)
    args = [a.to(dev) for a in (
        inv, torch.tensor([0, 0]), torch.tensor([1, 1]),
        torch.tensor([0.3, 0.7]), torch.tensor([0, 5, 5 + n_photons]),
        torch.rand(5 + n_photons, generator=torch.Generator().manual_seed(3)))]
    kw = {'t_max': math.inf}
    if bound:
        kw['t_max'] = gasgap_time_max(inv.numpy(),
                                      np.array([0.1, 0.2], np.float32),
                                      np.array([0.13, 0.17]))
    if fits:
        def fn():
            return s2.lumi_gasgap_times(*args, **kw)
        assert not (_sync_free(fn) if bound else fn()).any()
        assert _scratch_is_zero(dev)
    else:
        with pytest.raises(OverflowError):
            s2.lumi_gasgap_times(*args, **kw)


def _on(x, device):
    """A (nested) dict of tensors on ``device``; anything else kept."""
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    return x.to(device) if isinstance(x, torch.Tensor) else x


def test_field_maps_passes_card_vs_cpu(dev, tmp_path):
    """The field_maps configuration's S1 and S2 passes (optical
    propagation splines, COMSOL, gas-gap warping, the field-dependency,
    se-gain and extraction maps) on 16 bench events: on the card and,
    from the same draws, through the twins on the CPU, photons bitwise,
    integer truth exact, float truth within rtol 1e-12; after a first
    call, which copies the configuration's luminescence grids to the card
    once, neither pass reads back."""
    from wfsim_tpu_torch.config import field_maps_overrides
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models.s1 import s1_draws, s1_photon_pass
    from wfsim_tpu_torch.models.s2 import s2_draws, s2_photon_pass
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    from wfsim_tpu_torch.resources.synthetic import write_field_maps
    write_field_maps(tmp_path, 5)
    cfg = default_config(seed=5, **field_maps_overrides(tmp_path))
    rd = RawData(cfg, device=dev)
    params_c = build_params(cfg, load_config(cfg), 'cpu')
    inst = bench_instructions(16, 2000, 300)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for typ, draw, run in ((1, s1_draws, s1_photon_pass),
                           (2, s2_draws, s2_photon_pass)):
        x, _b, _r, n_rows = rd.batch_inputs(
            inst, np.flatnonzero(inst['type'] == typ), 's1' if typ == 1
            else 's2')
        draws = draw(rd.params, rd.const, x, gen)
        run(rd.params, rd.const, x, draws, n_truth_rows=n_rows)
        card = _sync_free(lambda: run(rd.params, rd.const, x, draws,
                                      n_truth_rows=n_rows))
        cpu = run(params_c, rd.const, _on(x, 'cpu'), _on(draws, 'cpu'),
                  n_truth_rows=n_rows)
        assert int(card[0]['t'].shape[0]) > 100
        for a, b in zip(card, cpu):
            for k, v in (a.items() if isinstance(a, dict) else [(0, a)]):
                w = b[k] if isinstance(b, dict) else b
                v = v.cpu()
                if v.dtype == torch.float64:
                    torch.testing.assert_close(v, w, rtol=1e-12, atol=0)
                else:
                    assert torch.equal(v, w), k


# ---------------------------------------------------------------------------
# the optical / nVeto input chain


def _launches(names):
    return [_build.KERNELS[n].launches for n in names]


OPTICAL_KERNELS = ('wfsim_pmt_photon_pass', 'wfsim_pmt_row_truth')


@pytest.mark.parametrize('detector', ['XENONnT', 'XENONnT_neutron_veto'])
def test_optical_response_card_vs_cpu(dev, detector):
    """The optical response (K8's photon pass and row truth, and with
    per-PMT truth on XENONnT K16) on the card and, from the same draws,
    through the twins on the CPU: photons and integer truth bitwise, float
    truth within rtol 1e-12; rows without photons included; no read-back."""
    from wfsim_tpu_torch.models.pmt import pmt_draws
    from wfsim_tpu_torch.pipeline.optical import optical_response
    n_ch = 494 if detector == 'XENONnT' else 120
    c = default_config(detector=detector,
                       per_pmt_truth=detector == 'XENONnT')
    const = build_constants(c)
    params = {d: build_params(c, load_config(c), d) for d in (dev, 'cpu')}
    rng = np.random.default_rng(6)
    counts = rng.poisson(900, 64)
    counts[[0, 5, 63]] = 0
    n = int(counts.sum())
    t = (rng.exponential(200.0, n) + np.repeat(
        rng.integers(0, 10 ** 6, 64), counts)).astype(np.int32)
    ch = rng.integers(0, n_ch, n).astype(np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    draws = pmt_draws(gen, n, dev)
    counts_t = torch.from_numpy(counts.astype(np.int64))

    def run(d):
        return optical_response(params[d], const,
                                torch.as_tensor(t, device=d),
                                torch.as_tensor(ch, device=d), counts_t,
                                _on(draws, d))
    names = OPTICAL_KERNELS + (('wfsim_pmt_row_truth_per_pmt',)
                               if detector == 'XENONnT' else ())
    torch.cuda.synchronize()
    before = _launches(names)
    ph_d, tr_d = run(dev)
    assert _launches(names) == [b + 1 for b in before]
    ph_c, tr_c = run('cpu')
    _bits(ph_d, ph_c, 'photons')
    assert tr_d.keys() == tr_c.keys()
    for k in tr_d:
        v, w = tr_d[k].cpu(), tr_c[k]
        if v.dtype == torch.float64:
            torch.testing.assert_close(v, w, rtol=1e-12, atol=0)
        else:
            assert torch.equal(v, w), k
    np.testing.assert_array_equal(tr_d['photon_count'].cpu().numpy(), counts)


@pytest.fixture
def strax_shim():
    """tests/strax_mock as strax, straxen and immutabledict.  The shim
    takes ``raw_record_dtype`` from wfsim_tpu, whose package imports JAX;
    where JAX is missing (the card's machine) the port's identical dtypes
    module stands in for ``wfsim_tpu.dtypes``."""
    import importlib.util
    import sys
    import types
    names = ('strax', 'straxen', 'immutabledict', 'wfsim_tpu',
             'wfsim_tpu.dtypes')
    saved = {k: sys.modules.get(k) for k in names}
    if importlib.util.find_spec('jax') is None:
        from wfsim_tpu_torch import dtypes
        pkg = types.ModuleType('wfsim_tpu')
        pkg.__path__ = []
        pkg.dtypes = dtypes
        sys.modules.update({'wfsim_tpu': pkg, 'wfsim_tpu.dtypes': dtypes})
    from tests.strax_mock import immutabledict, strax, straxen
    sys.modules.update(strax=strax, straxen=straxen,
                       immutabledict=immutabledict)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_nveto_plugin_compute_on_card(dev, strax_shim, monkeypatch):
    """One RawRecordsFromFaxnVeto compute on the card (the plugin's
    default device) through tests/strax_mock, its GEANT4 tree from a stub
    ``uproot``: nVeto records on channels 2000-2119, one truth row per
    optical instruction with its kept photons, K8 and the afterpulse
    kernels launched."""
    import importlib
    import sys
    import types
    import wfsim_tpu_torch.interface.strax_plugins as sp
    from .test_torch_strax_plugins import nveto_plugin_config
    importlib.reload(sp)
    try:
        assert sp.HAVE_STRAX and sp.SimulatorPlugin.device == 'cuda'
        cfg, g4 = nveto_plugin_config()
        monkeypatch.setitem(sys.modules, 'uproot',
                            types.SimpleNamespace(open=lambda path: g4))
        p = sp.RawRecordsFromFaxnVeto(config=cfg)
        p.setup()
        assert p.sim_nv.rawdata.device.type == 'cuda'
        names = OPTICAL_KERNELS + ('wfsim_pmt_ap_select',
                                   'wfsim_zle_intervals',
                                   'wfsim_superpose_adc')
        before = _launches(names)
        out = p.compute()
        assert all(a > b for a, b in zip(_launches(names), before))
        rr, truth = out['raw_records_nv'].data, out['truth_nv'].data
        assert len(rr) > 0 and np.diff(rr['time']).min() >= 0
        assert rr['channel'].min() >= 2000 and rr['channel'].max() <= 2119
        ins = p.instructions_nveto
        kept = ins['_last'] - ins['_first']
        got = zip(truth['g4id'].tolist(), truth['n_photon'].tolist())
        assert sorted(got) == sorted(zip(ins['g4id'].tolist(),
                                         kept.tolist()))
        assert p.source_finished()
    finally:
        sys.modules.pop('strax', None)
        importlib.reload(sp)
