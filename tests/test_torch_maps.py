"""Map files, map lookups, the inverse FDC and the NEST timing tables of
wfsim_tpu_torch against wfsim_tpu, on the CPU.

Tolerances, per quantity:

- a straxen regular-grid pattern map read by both packages: values, lows
  and highs bitwise, and the derived S2 correction and S1 LCE maps
  bitwise (the same numpy arithmetic);
- ``regrid_scattered`` on a seeded scattered map: within 1e-6 relative
  (the same float64 numpy/scipy estimator, rounded to float32 once);
- ``grid_lookup`` on a 1-d, a 2-d x 494 and a 3-d map: bitwise against a
  numpy float32 oracle of wfsim_tpu's operations, each rounded once in
  order; against wfsim_tpu on the CPU within rtol 5e-7 (2 ulp), because
  XLA contracts each corner's ``out + weight * value`` into one fused
  multiply-add (shown below: a fused emulation matches XLA on the 1-d
  map), which the port, like the card's kernel, rounds twice;
- the inverse FDC positions: within 1e-6 relative (sqrt and division in
  the same order; XLA may contract a product and a sum);
- the NEST tables at n_samples=2000: bitwise (the same generator calls in
  the same order).
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import wfsim_tpu.resources.loader as jax_loader

from wfsim_tpu.config import default_config as jax_default_config
from wfsim_tpu.models.params import (build_params as jax_build_params,
                                     build_constants as jax_build_constants)
from wfsim_tpu.models.s2 import (
    inverse_field_distortion_correction as jax_inverse_fdc)
from wfsim_tpu.ops.interp import (grid_lookup as jax_grid_lookup,
                                  regrid_scattered as jax_regrid_scattered)
from wfsim_tpu.resources.loader import (
    Resource as JaxResource, make_patternmap as jax_make_patternmap)
from wfsim_tpu.resources.nest_tables import (
    build_nest_timing_tables as jax_nest_tables)

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.models.s2 import inverse_field_distortion_correction
from wfsim_tpu_torch.ops.interp import (GridMap, grid_lookup,
                                        grid_lookup_ref, regrid_scattered)
from wfsim_tpu_torch.resources.loader import (
    Resource, make_map, make_patternmap, get_file_path)
from wfsim_tpu_torch.resources.nest_tables import build_nest_timing_tables
from wfsim_tpu_torch.resources.synthetic import write_pattern_map

SEED = 20261016


@pytest.fixture(scope='module')
def pattern_file(tmp_path_factory):
    return write_pattern_map(tmp_path_factory.mktemp('maps') / 'pmap.json',
                             SEED)


@contextlib.contextmanager
def jax_pattern_maps():
    """wfsim_tpu's ``make_patternmap`` zeroes dead PMTs in place on a
    read-only view of its device array, so every file pattern map raises
    there (ROADMAP Queue 3 F11).  Inside this context it does the same on
    a writable copy; the package's files are untouched."""
    def make_patternmap(entry, config=None, pmt_mask=None, n_grid=30):
        m = jax_loader.make_map(entry, config, n_grid=n_grid)
        if isinstance(m, jax_loader.MultiMap) and pmt_mask is not None:
            for g in m.maps.values():
                vals = np.array(g.values)
                if vals.shape[-1] == len(pmt_mask):
                    vals[..., ~np.asarray(pmt_mask)] = 0.0
                    g.values = jnp.asarray(vals)
        return m
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loader, 'make_patternmap', make_patternmap)
        yield


def bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def same_grid(jax_map, port_map):
    for part in ('values', 'lows', 'highs'):
        np.testing.assert_array_equal(
            bits(getattr(jax_map, part)),
            bits(getattr(port_map, part).numpy()), err_msg=part)


def test_pattern_map_file_reads_the_same(pattern_file):
    with open(pattern_file) as f:
        payload = json.load(f)
    vals = np.asarray(payload['map'], np.float32)
    assert vals.shape == (30, 30, 494) and vals.min() > 0
    sums = vals.astype(np.float64).sum(axis=-1)
    np.testing.assert_allclose(sums, 494 * 30e-5, rtol=0.06)
    live = np.ones(494, bool)
    with pytest.raises(ValueError, match='read-only'):
        jax_make_patternmap(pattern_file, {}, live)        # F11
    with jax_pattern_maps():
        mj = jax_loader.make_patternmap(pattern_file, {}, live)
    mt = make_patternmap(pattern_file, {}, live)
    assert mj.default == mt.default == 'map'
    same_grid(mj.maps['map'], mt.maps['map'])
    mask = live.copy()
    mask[[3, 200]] = False
    masked = make_patternmap(pattern_file, {}, mask).maps['map'].values
    assert np.all(masked.numpy()[..., [3, 200]] == 0)
    np.testing.assert_array_equal(masked.numpy()[..., mask],
                                  np.asarray(mj.maps['map'].values)[..., mask])


def test_file_map_resources_match(pattern_file):
    """The file pattern map and what is derived from it: the S2
    correction (pattern sum over its median), the LCE (pattern sum) and
    the area-fraction-top rescale."""
    over = dict(s2_pattern_map=pattern_file, s1_pattern_map=pattern_file,
                s2_mean_area_fraction_top=0.7, s2_correction_map=None)
    with jax_pattern_maps():
        rj = JaxResource(jax_default_config(**over))
    rt = Resource(default_config(**over))
    same_grid(rj.s2_pattern_map.maps['map'], rt.s2_pattern_map.maps['map'])
    same_grid(rj.s2_correction_map, rt.s2_correction_map)
    same_grid(rj.s1_lce_correction_map, rt.s1_lce_correction_map)


def test_missing_map_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        make_map('no_such_map.json', {'url_base': str(tmp_path)})
    (tmp_path / 'here.json').write_text('{}')
    assert get_file_path({'url_base': str(tmp_path)}, 'here.json') \
        == str(tmp_path / 'here.json')


def test_regrid_scattered_matches_jax():
    rng = np.random.default_rng(SEED)
    pts = rng.uniform(-40, 40, (300, 2))
    vals = np.stack([np.exp(-(pts ** 2).sum(1) / 800), pts[:, 0] / 40 + 2],
                    axis=1)
    mj = jax_regrid_scattered(pts, vals, n_grid=20)
    mt = regrid_scattered(pts, vals, n_grid=20)
    for part in ('values', 'lows', 'highs'):
        np.testing.assert_allclose(getattr(mt, part).numpy(),
                                   np.asarray(getattr(mj, part)), rtol=1e-6,
                                   err_msg=part)


def _random_map(rng, shape, out_dim):
    vals = rng.uniform(0.5, 2.0, shape + (out_dim,)).astype(np.float32)
    lows = rng.uniform(-60, -10, len(shape)).astype(np.float32)
    highs = (lows + rng.uniform(20, 120, len(shape))).astype(np.float32)
    return vals, lows, highs


def lookup_oracle(vals, lows, highs, pts, fused=False):
    """wfsim_tpu's grid_lookup in numpy float32, each operation rounded
    once; ``fused`` rounds each corner's ``out + weight * value`` once
    (a float64 product and sum, then float32), as XLA's CPU code does."""
    f32 = np.float32
    d = pts.shape[1]
    g = np.array(vals.shape[:-1])
    gm1 = (g - 1).astype(f32)
    span = np.maximum(highs - lows, f32(1e-30))
    f = np.minimum(np.maximum((pts - lows) / span * gm1, f32(0)), gm1)
    i0 = np.minimum(np.maximum(np.floor(f).astype(np.int64), 0), g - 1)
    w = f - i0.astype(f32)
    flat = vals.reshape(-1, vals.shape[-1])
    strides = np.cumprod(np.r_[g[1:], 1][::-1])[::-1]
    out = np.zeros((len(pts), vals.shape[-1]), f32)
    for corner in range(2 ** d):
        bits_ = np.array([(corner >> k) & 1 for k in range(d)])
        idx = np.minimum(i0 + bits_, g - 1)
        weight = np.ones(len(pts), f32)
        for k in range(d):
            weight = weight * (w[:, k] if bits_[k] else f32(1) - w[:, k])
        v = flat[(idx * strides).sum(axis=1)]
        if fused:
            out = (out.astype(np.float64) + weight[:, None].astype(np.float64)
                   * v.astype(np.float64)).astype(f32)
        else:
            out = out + weight[:, None] * v
    return out[:, 0] if vals.shape[-1] == 1 else out


@pytest.mark.parametrize('shape,out_dim', [((17,), 1), ((30, 30), 494),
                                           ((8, 9, 10), 1)])
def test_grid_lookup_matches_jax(shape, out_dim):
    rng = np.random.default_rng(SEED + len(shape))
    vals, lows, highs = _random_map(rng, shape, out_dim)
    n = 257
    pts = rng.uniform(lows - 15, highs + 15, (n, len(shape))).astype(
        np.float32)
    pts[:3] = lows            # on the lower edge
    pts[3:6] = highs          # on the upper edge
    j = np.asarray(jax_grid_lookup(jnp.asarray(vals), jnp.asarray(lows),
                                   jnp.asarray(highs), jnp.asarray(pts)))
    args = [torch.from_numpy(a) for a in (vals, lows, highs, pts)]
    t = grid_lookup(*args).numpy()
    assert t.shape == j.shape
    np.testing.assert_array_equal(bits(t),
                                  bits(lookup_oracle(vals, lows, highs, pts)))
    np.testing.assert_array_equal(bits(grid_lookup_ref(*args).numpy()),
                                  bits(t))
    np.testing.assert_allclose(t, j, rtol=5e-7, atol=0)
    if len(shape) == 1:
        np.testing.assert_array_equal(
            bits(lookup_oracle(vals, lows, highs, pts, fused=True)), bits(j))


def test_constant_map_lookup():
    m = GridMap.constant(0.5, out_dim=3, ndim_in=2)
    out = m(torch.tensor([[10.0, -3.0], [0.2, 0.7]]))
    assert out.shape == (2, 3) and torch.all(out == 0.5)


@pytest.mark.parametrize('dr', [0.5, 1.5])
def test_inverse_fdc_matches_jax(dr):
    over = dict(field_distortion_model='inverse_fdc',
                fdc_3d=['constant dummy', dr, []])
    cj = jax_default_config(**over)
    pj = jax_build_params(cj, JaxResource(cj))
    c = default_config(**over)
    pt = build_params(c, Resource(c), 'cpu')
    same_grid(pj.fdc_3d, pt.fdc_3d)
    rng = np.random.default_rng(SEED)
    n = 64
    r = np.sqrt(rng.uniform(0, 45 ** 2, n))
    phi = rng.uniform(-np.pi, np.pi, n)
    x, y = (r * np.cos(phi)).astype(np.float32), (r * np.sin(phi)).astype(
        np.float32)
    z = rng.uniform(-90, -1, n).astype(np.float32)
    zj, xyj = jax_inverse_fdc(pj, jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(z))
    zt, xyt = inverse_field_distortion_correction(
        pt, *(torch.from_numpy(a) for a in (x, y, z)))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6)
    np.testing.assert_allclose(xyt.numpy(), np.asarray(xyj), rtol=1e-6,
                               atol=1e-6)
    r_out = np.linalg.norm(xyt.numpy(), axis=1)
    np.testing.assert_allclose(r_out, r - dr, atol=0.2)


def test_nest_tables_match_jax():
    c = default_config(s1_model_type='nest')
    tj = jax_nest_tables(jax_default_config(s1_model_type='nest'),
                         n_samples=2000)
    tt = build_nest_timing_tables(c, n_samples=2000)
    assert tt[0].shape == (4, 16, 16, 2048)
    for a, b in zip(tj, tt):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(bits(a), bits(b))
    assert np.all(np.diff(tt[0], axis=-1) >= 0)


def test_detector_physics_constants_match_jax(pattern_file):
    from wfsim_tpu_torch.config import detector_physics_overrides
    over = detector_physics_overrides(pattern_file)
    over['s1_model_type'] = 'simple'        # keeps the default NEST build out
    kj = jax_build_constants(jax_default_config(**over))
    kt = build_constants(default_config(**over))
    assert dataclasses.asdict(kj) == dataclasses.asdict(kt)
