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
