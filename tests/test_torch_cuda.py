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
    """Select, emit and the whole generator, with a uniform element so both
    branches of emit run."""
    from wfsim_tpu_torch.models import afterpulse as ap
    c, params, const = realistic
    n = 200_000
    ph = {k: torch.as_tensor(v, device=dev)
          for k, v in photon_set(seed, n).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    draws = ap.pmt_ap_draws(gen, params.pmt_ap_delay_cdf.shape[0], n, dev)
    sel = ap._select(params, const, ph, draws)
    assert torch.equal(sel, ap._select_ref(params, const, ph, draws))
    take = torch.nonzero(sel.reshape(-1)).squeeze(1)
    for a, b in zip(ap._emit(params, const, ph, draws, take),
                    ap._emit_ref(params, const, ph, draws, take)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    k = _build.KERNELS['wfsim_pmt_ap_emit']
    before = k.launches
    out, info = ap.pmt_afterpulse_photons(params, const, ph, draws,
                                          n_truth_rows=8)
    assert k.launches == before + 1
    ref, info_r = ap.pmt_afterpulse_photons_ref(params, const, ph, draws,
                                                n_truth_rows=8)
    assert info['total'] == info_r['total'] > 0
    for key in out:
        assert torch.equal(out[key], ref[key]), key
    for key in ('counts', 't_min', 't_max'):
        assert torch.equal(info[key], info_r[key]), key


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


def test_channel_draw_matches_twins(dev):
    from wfsim_tpu_torch.ops.randsample import channel_draw, channel_draw_ref
    rng = np.random.default_rng(21)
    I, C = 37, 494
    pat = (rng.random((I, C)) * (rng.random((I, C)) > 0.2)).astype(np.float32)
    pat[5] = 0.0                                   # a row without mass
    pat[:, 17] = 0.0                               # a channel never drawn
    counts = rng.integers(0, 3000, I)
    counts[3] = 0
    edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
    u = torch.as_tensor(rng.random(int(counts.sum())).astype(np.float32))
    args = [torch.as_tensor(pat), edges, u]
    cpu = channel_draw(*args)
    k = _build.KERNELS['wfsim_channel_draw']
    before = k.launches
    card = channel_draw(*[a.to(dev) for a in args])
    assert k.launches == before + 1
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(card, channel_draw_ref(*[a.to(dev) for a in args]))


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
        return None if v is None else v.cpu()

    ph_d, tr_d, req_d = fn(params, const, x, d, n_truth_rows=n_rows)
    ph_c, tr_c, req_c = fn(build_params(c, load_config(c), 'cpu'), const,
                           cpu(x), cpu(d), n_truth_rows=n_rows)
    _same(ph_d, ph_c)
    _same(tr_d, tr_c, FLOAT_TRUTH)
    assert torch.equal(req_d.cpu(), req_c)
