"""The channel draw (K5) and the map lookup (K12a) of wfsim_tpu_torch, as
their CUDA kernels were redesigned, against wfsim_tpu on the CPU.

On the CPU both run their plain twins; these tests pin what the kernels
must reproduce at the shapes that exposed the first designs: a channel
draw with one instruction far larger than the rest, and a map lookup at
photon width on a 3-d map whose grid constants are cached on the map.

Tolerances, per quantity:

- channels against wfsim_tpu's ``jnp.cumsum`` + ``categorical_from_cdf``
  given the same uniforms: equal in every row whose two CDFs agree
  bitwise; in the other rows (wfsim_tpu sums the pattern in float32, the
  port in float64 rounded once per entry) at most one index apart, and
  the number of differing photons is reported;
- the map lookup: bitwise against wfsim_tpu's ``grid_lookup`` evaluated
  op by op (``jax.disable_jit``: each operation rounded once, in the
  port's order), and within rtol 5e-7 of the jitted one (XLA's CPU code
  contracts each corner's ``out + weight * value`` into one fused
  multiply-add; see tests/test_torch_maps.py).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import build_constants as jax_build_constants
from wfsim_tpu.ops.interp import grid_lookup as jax_grid_lookup
from wfsim_tpu.ops.randsample import categorical_from_cdf

from wfsim_tpu_torch.models.params import params_from_numpy
from wfsim_tpu_torch.ops.interp import GridMap
from wfsim_tpu_torch.ops.randsample import channel_draw, cumsum_f64

SEED = 20261017


def skewed_batch(rng, big=200_000):
    """64 rows x 494 channels: one row of ``big`` photons, rows without
    photons (the first and the last among them) and rows without mass; all
    other entries positive, so no channel has zero width."""
    I, C = 64, 494
    pat = rng.uniform(0.01, 1.0, (I, C)).astype(np.float32)
    pat[[5, 40]] = 0.0
    counts = rng.integers(1, 3000, I)
    counts[17] = big
    counts[[0, 9, 33, I - 1]] = 0
    u = rng.random(int(counts.sum()), dtype=np.float32)
    u[::997] = 0.0
    u[3::997] = np.float32(1 - 2 ** -24)
    return pat, counts, u


def test_channel_draw_skewed_matches_jax():
    pat, counts, u = skewed_batch(np.random.default_rng(SEED))
    edges = np.concatenate([[0], np.cumsum(counts)])
    ch = channel_draw(torch.from_numpy(pat), torch.from_numpy(edges),
                      torch.from_numpy(u)).numpy()
    rows = np.repeat(np.arange(len(counts)), counts)
    cdf_j = jnp.cumsum(jnp.asarray(pat), axis=1)
    ch_j = np.asarray(categorical_from_cdf(cdf_j, jnp.asarray(rows),
                                           jnp.asarray(u)))
    same_cdf = np.all(np.asarray(cdf_j).view(np.int32) == cumsum_f64(
        torch.from_numpy(pat), 1).numpy().view(np.int32), axis=1)
    exact = same_cdf[rows]
    np.testing.assert_array_equal(ch[exact], ch_j[exact])
    assert np.all(np.abs(ch[~exact] - ch_j[~exact]) <= 1)
    assert np.all(ch[np.isin(rows, [5, 40])] == -1)
    assert ch.shape == (int(edges[-1]),) and ch.min() >= -1
    n_diff = int((ch != ch_j).sum())
    print(f'rows with differing CDFs {int((~same_cdf).sum())} of '
          f'{len(counts)}; photons drawn differently {n_diff} of {len(u)}')


@pytest.mark.parametrize('n_u', [999, 1001])
def test_channel_draw_count_mismatch_raises_on_cpu(n_u):
    """The CPU path still checks edges[-1] against the uniforms (the card
    path reads nothing back; see channel_draw)."""
    pat = torch.ones((2, 8), dtype=torch.float32)
    edges = torch.tensor([0, 400, 1000])
    with pytest.raises(ValueError):
        channel_draw(pat, edges, torch.zeros(n_u, dtype=torch.float32))


def photon_width_map(rng, n):
    """A 50 x 50 x 100 float32 map and ``n`` points around and on it: at
    the lows, on the upper faces, outside."""
    lows = np.array([-70, -70, -150], np.float32)
    highs = np.array([70, 70, 0], np.float32)
    vals = rng.uniform(0.05, 0.3, (50, 50, 100, 1)).astype(np.float32)
    pts = rng.uniform(lows - 5, highs + 5, (n, 3)).astype(np.float32)
    pts[:200] = lows
    pts[200:400] = highs
    pts[400:600, 2] = highs[2]
    pts[600:800, 0] = highs[0]
    return vals, lows, highs, pts


def _port_map(how, vals, lows, highs):
    if how == 'built':
        return GridMap(*map(torch.from_numpy, (vals, lows, highs)))
    if how == 'to_cpu':
        return GridMap(*map(torch.from_numpy, (vals, lows, highs))).to('cpu')
    tree = {'fdc_3d.values': vals, 'fdc_3d.lows': lows,
            'fdc_3d.highs': highs}
    const = dataclasses.asdict(jax_build_constants(jax_default_config()))
    return params_from_numpy(tree, const, 'cpu')[0].fdc_3d


@pytest.mark.parametrize('how', ['built', 'to_cpu', 'params_from_numpy'])
def test_grid_lookup_photon_width_matches_jax(how):
    vals, lows, highs, pts = photon_width_map(np.random.default_rng(SEED),
                                              20_000)
    gmap = _port_map(how, vals, lows, highs)
    assert gmap.grid == (3, (50, 50, 100), 1)
    out = gmap(torch.from_numpy(pts)).numpy()
    args = [jnp.asarray(a) for a in (vals, lows, highs, pts)]
    with jax.disable_jit():
        eager = np.asarray(jax_grid_lookup(*args))
    assert out.shape == eager.shape == (len(pts),)
    np.testing.assert_array_equal(out.view(np.int32), eager.view(np.int32))
    np.testing.assert_allclose(out, np.asarray(jax_grid_lookup(*args)),
                               rtol=5e-7, atol=0)


def test_grid_constants_follow_the_map():
    """The cached constants follow a rescale in place (as the resource
    loader does) and a move; a map past three dimensions has none and
    still runs the twin on the CPU."""
    m = GridMap.constant(0.5, out_dim=3, ndim_in=2)
    assert m.grid == (2, (2, 2, 1), 3)
    m.values = torch.zeros((4, 5, 3), dtype=torch.float32)
    assert m.grid == (2, (4, 5, 1), 3) and m.to('cpu').grid == m.grid
    m4 = GridMap(torch.ones((2, 2, 2, 2, 1)), torch.zeros(4), torch.ones(4))
    assert m4.grid is None
    assert torch.equal(m4(torch.full((3, 4), 0.5)), torch.ones(3))


@pytest.mark.parametrize('shape,out_dim,n', [
    ((100,), 1, 20_000), ((50, 100), 1, 20_000), ((30, 30), 494, 512)])
def test_grid_lookup_spline_and_pattern_shapes_match_jax(shape, out_dim, n):
    """The maps of lower dimension the kernel takes: a 1-d (u) and a 2-d
    (z, u) one-output map, as the optical splines look up at photon width,
    and the 30 x 30 x 494 pattern map at the S2 batch's instruction width;
    points inside, outside, at the lows and on the upper faces; bitwise
    against wfsim_tpu's grid_lookup evaluated op by op."""
    rng = np.random.default_rng(SEED)
    d = len(shape)
    lows = rng.uniform(-80, -20, d).astype(np.float32)
    highs = rng.uniform(20, 80, d).astype(np.float32)
    vals = rng.uniform(0.05, 0.3, shape + (out_dim,)).astype(np.float32)
    pts = rng.uniform(lows - 5, highs + 5, (n, d)).astype(np.float32)
    pts[:50] = lows
    pts[50:100] = highs
    pts[100:150, -1] = highs[-1]
    gmap = GridMap(*map(torch.from_numpy, (vals, lows, highs)))
    assert gmap.grid == (d, shape + (1,) * (3 - d), out_dim)
    out = gmap(torch.from_numpy(pts)).numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_grid_lookup(
            *[jnp.asarray(a) for a in (vals, lows, highs, pts)]))
    assert out.shape == eager.shape == ((n,) if out_dim == 1 else
                                        (n, out_dim))
    np.testing.assert_array_equal(out.view(np.int32), eager.view(np.int32))
