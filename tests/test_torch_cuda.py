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
