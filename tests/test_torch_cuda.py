"""The hand-written CUDA kernels of wfsim_tpu_torch against their plain
PyTorch twins, on the card.  Every test skips without a CUDA device.

Run on a machine with the card (tests/conftest.py imports JAX, which the
port's machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bitwise — each kernel adds, compares and copies exactly what
its twin does, in the same order.
"""
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
from .test_torch_lumi_summaries_redesign import (
    LUMI_CASES, SUMMARY_CASES, lumi_case, sequential_rows_np, summary_case)
from .test_torch_pmt_truth_order import (
    SECOND_PASS, TRUTH_CASES, emulate_per_pmt, emulate_row_truth,
    photon_terms, truth_case)
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
                        torch.as_tensor(pieces, device=dev), n_samples=T)
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
                                    [1] * 7 + [0] + [40_000] * 5])
def test_custom_delays_match_twin(dev, counts):
    """Every recoil class (ER 7 and 8, NR, alpha, LED), recombination
    uniforms of 0, an empty batch and instructions without photons."""
    from wfsim_tpu_torch.models import s1
    const = build_constants(default_config(s1_model_type='custom'))
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
    edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]),
                            device=dev)
    k = _build.KERNELS['wfsim_s1_custom_delays']
    before = k.launches
    got = s1.custom_delays(cls, edges, draws, const=const)
    assert k.launches == before + (1 if n else 0)
    want = s1.custom_delays_ref(cls, edges, draws, const=const)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize('confine,counts', [
    (-1.0, []), (-1.0, [0]), (-1.0, [300] * 64 + [0] + [7]),
    (0.1, [1000] * 20 + [0])])
def test_garfield_times_match_twin(dev, confine, counts):
    """Both wire-distance modes, positions on both sides of the wires, an
    empty batch and instructions without photons."""
    from wfsim_tpu_torch.models import s2
    from wfsim_tpu_torch.models.params import table_mean_int
    from wfsim_tpu_torch.resources.synthetic import synthetic_garfield_table
    tbl = synthetic_garfield_table(3)
    rng = np.random.default_rng(len(counts))
    counts = np.asarray(counts, np.int64)
    n_i, n = len(counts), int(counts.sum())
    xy = rng.uniform(-60, 60, (n_i, 2)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (
        tbl['t'], tbl['x'], xy, np.concatenate([[0], np.cumsum(counts)]),
        rng.integers(0, tbl['t'].shape[1], n))]
    u_wire = (torch.as_tensor(rng.random(n_i).astype(np.float32), device=dev)
              if confine > 0 else None)
    kw = dict(avgt=table_mean_int(tbl['t']), tilt=np.pi / 4, pitch=0.5,
              confine=confine)
    k = _build.KERNELS['wfsim_lumi_garfield_times']
    before = k.launches
    got = s2.lumi_garfield_times(*args, u_wire, **kw)
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
                        torch.as_tensor(pieces, device=dev), n_samples=T)
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


@pytest.mark.parametrize('n_blocks,n_ch_shards,T', [(1, 1, 2048),
                                                    (2, 2, 1000),
                                                    (3, 4, 512)])
def test_superpose_block_matches_twin(setup, dev, n_blocks, n_ch_shards, T):
    """K14's channel block: int32 ADC and the bottom-array sum rows of
    every channel block, bitwise the twin's, with launches counted."""
    from wfsim_tpu_torch.ops.waveform import (superpose_block,
                                              superpose_block_ref)
    from wfsim_tpu_torch.parallel.sharding import block_photons
    _c, params, const = setup
    C, n_top = const.n_tpc_pmts, const.n_top_pmts
    rng = np.random.default_rng(T + n_blocks)
    n = 20_000 * n_blocks
    ph = dict(t=rng.integers(-500, T * 10 + 500, n).astype(np.int32),
              ch=rng.integers(-1, C, n).astype(np.int32),
              gain=rng.uniform(1e5, 8e6, n).astype(np.float32),
              valid=rng.random(n) < 0.97)
    ph = {k: torch.as_tensor(v, device=dev) for k, v in ph.items()}
    block = torch.as_tensor(rng.integers(0, n_blocks, n), device=dev)
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
                        torch.as_tensor(pieces, device=dev), n_samples=T)
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
    """The truth kernels' scratch buffers on ``dev`` (one per stream) are
    all zero."""
    from wfsim_tpu_torch.models import pmt
    torch.cuda.synchronize()
    bufs = [b for (d, _s), b in pmt._SCRATCH.items() if d == dev]
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
    assert keys <= set(pmt._SCRATCH)
    assert len({pmt._SCRATCH[k].data_ptr() for k in keys}) == 2
    for out in got:
        _bits(out, {k: v.cpu().numpy() for k, v in want.items()}, 'stream')
    assert _scratch_is_zero(dev)
