"""The PMT-afterpulse generator (``pmt_afterpulse_photons``, K11) and the
diffused S2 pattern (``pattern_diffuse``, K12b) of wfsim_tpu_torch — on the
CPU their plain twins — against wfsim_tpu's ``pmt_afterpulse_photons`` and
``s2_pattern_map_diffuse`` given the same draws, and the afterpulse output
order against a numpy oracle of the position the kernel computes for each
selected slot, on the cases to which the kernels are sensitive:
``csrc/pmt_afterpulse.cu`` (a bit mask and a count a tile of 1,024
photons, each truth row's photon range by a search of the ascending rows,
the slot's position from the row's range and the tiles' prefix, no sort)
and ``csrc/grid_lookup.cu``'s ``pattern_diffuse`` (a block an instruction,
each electron's geometry computed once into shared memory in tiles of the
block's threads, the corner values reloaded when the cell changes).
tests/test_torch_cuda.py holds the kernels bitwise against the twins on
the same cases.

The cases are numpy only, made from a seed (``ap_case``, ``ap_draws``,
``diffuse_case``, ``diffuse_normals``), so that the card's machine, which
has no JAX, can import them: JAX is imported inside the fixtures that use
it.

Tolerances: the afterpulse photons bitwise on the first ``total`` slots,
and the counts, t_min and t_max bitwise (the twin repeats wfsim_tpu's
float32 operations one for one); the oracle's order exactly; the diffused
pattern within rtol 1e-6 of wfsim_tpu's, as in
tests/test_torch_detector_physics.py (wfsim_tpu takes the azimuth through
arctan2, cos and sin, the port through x / r and y / r), with wfsim_tpu's
per-electron lookups summed in float64 (wfsim_tpu sums them in float32,
the port in float64: ROADMAP F12; its float32 means differ from the
port's by ~5e-5 on the instruction of 20,000, the size of one electron
dropped); and within rtol 1e-12 of a
float64 numpy mean of the twin's own per-electron lookups.
"""
import types

import numpy as np
import pytest
import torch

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models import afterpulse as ap
from wfsim_tpu_torch.models import s2
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.ops.interp import GridMap, grid_lookup_ref
from wfsim_tpu_torch.resources import load_config

from .ap_inputs import N_CH, ap_tables

# ---------------------------------------------------------------------------
# K11 cases

#: the photons and truth rows of a case (every case but the last shares
#: them, so wfsim_tpu compiles once)
AP_N, AP_ROWS = 40_000, 16
AP_CASES = (
    'a bench-like set',
    'one truth row with 90 % of the photons',
    'empty rows',
    'no valid photon',
    'all double-PE',
    'rows ending on tile and word edges',
)
#: the cases held against wfsim_tpu (same shapes: one compile)
JAX_AP_CASES = AP_CASES[:5]
#: the row boundaries of the last case: 8 rows over 16 tiles of 1,024
#: photons, each ending on a 32-photon word or a tile, rows 8 and 9 empty
TILE_EDGES = (0, 32, 1024, 1056, 4096, 8192, 8224, 16352, 16384)


def ap_case(name):
    """(photons as numpy arrays, n_rows): t int32, ch int32 (-1 for no
    channel), is_dpe, valid (bool), truth_row int64 ascending."""
    rng = np.random.default_rng(AP_CASES.index(name) + 1200)
    n, n_rows = AP_N, AP_ROWS
    if name == 'rows ending on tile and word edges':
        n, n_rows = TILE_EDGES[-1], len(TILE_EDGES) + 1
    ch = rng.integers(-1, N_CH, n).astype(np.int32)
    valid = (ch >= 0) & (rng.random(n) < 0.95)
    rows = rng.integers(0, n_rows, n)
    if name == 'one truth row with 90 % of the photons':
        rows[: n * 9 // 10] = 5
    elif name == 'empty rows':
        rows = rng.choice([2, 3, 7, 8, 12], n)       # 0, 1, ..., 15 empty
    elif name == 'no valid photon':
        valid[:] = False
    elif name == 'rows ending on tile and word edges':
        rows = np.repeat(np.arange(len(TILE_EDGES) - 1),
                         np.diff(TILE_EDGES))
    return dict(t=rng.integers(0, 1_000_000, n).astype(np.int32),
                ch=np.where(valid, ch, -1).astype(np.int32),
                is_dpe=(np.ones(n, bool) if name == 'all double-PE'
                        else rng.random(n) < 0.2),
                valid=valid, truth_row=np.sort(rows).astype(np.int64)), \
        n_rows


def ap_draws(name, n_elements, n):
    """The (E, n) float32 uniforms u0, u1, u2 of a case, from numpy."""
    rng = np.random.default_rng(AP_CASES.index(name) + 1300)
    return {k: rng.random((n_elements, n), dtype=np.float32)
            for k in ('u0', 'u1', 'u2')}


def ap_order_oracle(sel, truth_row):
    """The flat slots ``e * n + i`` of the selected slots ``sel`` (E, n)
    in output order, placed where csrc/pmt_afterpulse.cu places them: slot
    (e, i) of row r at base(r, e) + (selected slots of element e in [rs_r,
    i)), base(r, e) = sum_e' P_e'(rs_r) + sum_{e' < e} (P_e'(re_r) -
    P_e'(rs_r)), P_e(x) the selected slots of element e among photons < x;
    also the per-row counts."""
    E, n = sel.shape
    P = np.concatenate([np.zeros((E, 1), np.int64),
                        np.cumsum(sel, axis=1)], axis=1)
    R = int(truth_row[-1]) + 1 if n else 0
    rs = np.searchsorted(truth_row, np.arange(R), side='left')
    re = np.searchsorted(truth_row, np.arange(R), side='right')
    order = np.full(int(sel.sum()), -1, np.int64)
    counts = np.zeros(R, np.int64)
    for r in range(R):
        base = P[:, rs[r]].sum()
        for e in range(E):
            idx = rs[r] + np.flatnonzero(sel[e, rs[r]:re[r]])
            order[base:base + len(idx)] = e * n + idx
            base += len(idx)
            counts[r] += len(idx)
    return order, counts


def ap_setup(device='cpu'):
    """(config, params, constants) with the three-element tables of
    tests/ap_inputs.py (Ar, He and a uniform element)."""
    c = default_config(enable_pmt_afterpulses=True,
                       photon_ap_cdfs=ap_tables())
    return c, build_params(c, load_config(c), device), build_constants(c)


def ap_args(name, params, dev='cpu'):
    """(photons, draws, n_rows) of a case as tensors on ``dev``."""
    ph, n_rows = ap_case(name)
    draws = ap_draws(name, int(params.pmt_ap_delay_cdf.shape[0]),
                     len(ph['t']))
    return ({k: torch.as_tensor(v, device=dev) for k, v in ph.items()},
            {k: torch.as_tensor(v, device=dev) for k, v in draws.items()},
            n_rows)


# ---------------------------------------------------------------------------
# K12b cases

DIFFUSE_CASES = (
    'an instruction of 20,000 electrons',
    'instructions without electrons',
    'electrons outside the TPC radius',
    'a map with one output',
)
#: the pattern map's grid: 30 x 30 points over [-50, 50] cm, as
#: resources/synthetic.py write_pattern_map
MAP_GRID, MAP_HALF = 30, 50.0
DIFFUSION = 5.0e-8                      # cm^2/ns, detector_physics's


def pattern_values(out_dim, seed=5):
    """A smooth positive (30, 30, out_dim) float32 map: a Gaussian spot
    (sigma 15 cm) a channel over a floor of 0.2 (write_pattern_map's
    shape; values within a factor of ~6)."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-MAP_HALF, MAP_HALF, MAP_GRID)
    gx, gy = np.meshgrid(ax, ax, indexing='ij')
    centre = rng.uniform(-MAP_HALF, MAP_HALF, (out_dim, 2))
    d2 = ((gx[..., None] - centre[:, 0]) ** 2
          + (gy[..., None] - centre[:, 1]) ** 2)
    vals = 0.2 + np.exp(-d2 / (2 * 15.0 ** 2))
    return (vals * 30e-5 * N_CH / vals.sum(-1, keepdims=True)).astype(
        np.float32)


def diffuse_case(name, tpc_radius):
    """One case: ``values`` (30, 30, 1 or 494) float32, ``x``, ``y``,
    ``z`` (I,) float32 instruction positions, ``counts`` (I,) int64
    electrons an instruction."""
    rng = np.random.default_rng(DIFFUSE_CASES.index(name) + 1400)
    I = 24
    counts = rng.integers(50, 400, I)
    r = np.sqrt(rng.uniform(0, (tpc_radius - 5) ** 2, I))
    z = rng.uniform(-140, -10, I)
    if name == 'an instruction of 20,000 electrons':
        counts[7] = 20_000
    elif name == 'instructions without electrons':
        counts[[0, 5, 6, I - 1]] = 0
    elif name == 'electrons outside the TPC radius':
        r[:I // 2] = tpc_radius - rng.uniform(0, 0.3, I // 2)
        r[3] = tpc_radius + 5.0                      # every electron out
        z[:I // 2] = -140.0                          # the widest spread
    phi = rng.uniform(-np.pi, np.pi, I)
    return dict(values=pattern_values(1 if name == 'a map with one output'
                                      else N_CH),
                x=(r * np.cos(phi)).astype(np.float32),
                y=(r * np.sin(phi)).astype(np.float32),
                z=z.astype(np.float32), counts=counts.astype(np.int64))


def diffuse_normals(name, n_e):
    """Two (n_e,) float32 standard normals of a case, from numpy."""
    rng = np.random.default_rng(DIFFUSE_CASES.index(name) + 1500)
    return [rng.standard_normal(n_e, dtype=np.float32) for _ in range(2)]


def diffuse_constants():
    return build_constants(default_config(
        diffusion_constant_transverse=DIFFUSION))


def diffuse_args(case, const, n_r, n_a, dev='cpu'):
    """The arguments of ``pattern_diffuse`` for a case and its normals."""
    t = lambda a: torch.as_tensor(a, device=dev)             # noqa: E731
    gmap = GridMap(t(case['values']),
                   t(np.full(2, -MAP_HALF, np.float32)),
                   t(np.full(2, MAP_HALF, np.float32)))
    xy = torch.stack([t(case['x']), t(case['y'])], dim=1)
    edges = np.concatenate([[0], np.cumsum(case['counts'])])
    return (gmap, t(case['x']), t(case['y']),
            *s2.diffusion_inputs(None, const, t(case['z']), xy),
            const.tpc_radius ** 2, t(edges), t(n_r), t(n_a), N_CH)


# ---------------------------------------------------------------------------
# K11 against wfsim_tpu and the oracle


@pytest.fixture(scope='module')
def ap_jax():
    """wfsim_tpu's generator with the same tables, and its draws from a key
    (one split of the key into three keys per element)."""
    import jax
    import jax.numpy as jnp
    from wfsim_tpu.config import default_config as jax_default_config
    from wfsim_tpu.models import afterpulse as jax_ap
    from wfsim_tpu.models.params import (
        build_params as jax_build_params,
        build_constants as jax_build_constants)
    from wfsim_tpu.resources.loader import load_config as jax_load_config
    cj = jax_default_config(enable_pmt_afterpulses=True,
                            photon_ap_cdfs=ap_tables())
    pj, kj = jax_build_params(cj, jax_load_config(cj)), \
        jax_build_constants(cj)

    def run(ph, key, n_rows):
        ph_j = {k: jnp.asarray(v.astype(np.int32) if k == 'truth_row'
                               else v) for k, v in ph.items()}
        out, info = jax_ap.pmt_afterpulse_photons(
            pj, kj, ph_j, key, ap_capacity=8192, n_truth_rows=n_rows)
        return ({k: np.asarray(v) for k, v in out.items()},
                {k: np.asarray(v) for k, v in info.items()})

    def draws(key, n_elements, n):
        eks = jax.random.split(key, 3 * n_elements)
        return {name: np.stack([np.asarray(jax.random.uniform(
            eks[3 * e + j], (n,))) for e in range(n_elements)])
            for j, name in enumerate(('u0', 'u1', 'u2'))}
    return types.SimpleNamespace(jax=jax, run=run, draws=draws)


@pytest.fixture(scope='module')
def ap_port():
    return ap_setup()


@pytest.mark.parametrize('name', JAX_AP_CASES)
def test_afterpulses_match_jax(ap_jax, ap_port, name):
    """Bitwise on the first ``total`` slots and on counts, t_min and t_max,
    given wfsim_tpu's draws."""
    _c, pt, kt = ap_port
    ph, n_rows = ap_case(name)
    key = ap_jax.jax.random.key(AP_CASES.index(name) + 100)
    E = int(pt.pmt_ap_delay_cdf.shape[0])
    out_j, info_j = ap_jax.run(ph, key, n_rows)
    draws = {k: torch.from_numpy(v)
             for k, v in ap_jax.draws(key, E, AP_N).items()}
    out_t, info_t = ap.pmt_afterpulse_photons(
        pt, kt, {k: torch.from_numpy(v) for k, v in ph.items()}, draws,
        n_truth_rows=n_rows)
    total = int(info_j['total'])
    assert info_t['total'] == total < 8192
    for k in ('t', 'ch', 'gain', 'truth_row'):
        a = out_j[k][:total]
        assert a.tobytes() == out_t[k].numpy().astype(a.dtype).tobytes(), k
    assert out_t['valid'].all() and not out_t['is_dpe'].any()
    for k in ('counts', 't_min', 't_max'):
        np.testing.assert_array_equal(info_j[k], info_t[k].numpy(),
                                      err_msg=k)
    if name == 'no valid photon':
        assert total == 0
    else:
        assert total > 0
        gains = out_t['gain'].numpy()      # both branches of emit ran
        assert 0 < np.sum(gains == pt.gains.numpy()[out_t['ch'].numpy()]) \
            < total


@pytest.mark.parametrize('name', AP_CASES)
def test_afterpulse_order_matches_oracle(ap_port, name):
    """The twin's photons are the emitted slots in the oracle's order; its
    counts are the oracle's; t_min and t_max are the rows' extremes."""
    _c, pt, kt = ap_port
    ph, draws, n_rows = ap_args(name, pt)
    out, info = ap.pmt_afterpulse_photons(pt, kt, ph, draws,
                                          n_truth_rows=n_rows)
    sel = ap._select_ref(pt, kt, ph, draws).numpy()
    rows = ph['truth_row'].numpy()
    order, counts = ap_order_oracle(sel, rows)
    assert np.array_equal(order, np.flatnonzero(sel.reshape(-1))[
        np.lexsort((np.flatnonzero(sel.reshape(-1)),
                    rows[np.flatnonzero(sel.reshape(-1)) % len(rows)]))])
    emitted = ap._emit_ref(pt, kt, ph, draws, torch.from_numpy(order))
    for k, x in zip(('t', 'ch', 'gain', 'truth_row'), emitted):
        assert torch.equal(out[k], x), k
    assert info['total'] == len(order)
    got = info['counts'].numpy()
    assert np.array_equal(got[:len(counts)], counts)
    assert not got[len(counts):].any()
    t = out['t'].numpy()
    r = out['truth_row'].numpy()
    for row in range(n_rows):
        if got[row]:
            assert info['t_min'][row] == t[r == row].min()
            assert info['t_max'][row] == t[r == row].max()
        else:
            assert info['t_min'][row] == 2 ** 31 - 1
            assert info['t_max'][row] == -(2 ** 31 - 1)
    if name == 'empty rows':
        assert (got == 0).sum() == n_rows - 5
    if name == 'one truth row with 90 % of the photons':
        assert got[5] > 0.85 * got.sum()


# ---------------------------------------------------------------------------
# K12b against wfsim_tpu and a float64 oracle


@pytest.fixture(scope='module')
def diffuse_jax():
    """wfsim_tpu's s2_pattern_map_diffuse with a map of the case's values
    (params and constants carry what the function reads), run with every
    electron an instruction of its own: each row is then that electron's
    lookup (times 1, over 1) or 0 outside the TPC, so the per-instruction
    mean is summed here in float64, not in wfsim_tpu's float32 (F12)."""
    import jax
    import jax.numpy as jnp
    from wfsim_tpu.config import default_config as jax_default_config
    from wfsim_tpu.models import s2 as js2
    from wfsim_tpu.models.params import build_constants as jax_constants
    from wfsim_tpu.ops.interp import GridMap as JaxGridMap
    kj = jax_constants(jax_default_config(
        diffusion_constant_transverse=DIFFUSION))

    def run(case, key):
        I = len(case['x'])
        e_inst = np.repeat(np.arange(I), case['counts'])
        E = len(e_inst)
        pj = types.SimpleNamespace(
            s2_pattern=JaxGridMap(case['values'],
                                  np.full(2, -MAP_HALF, np.float32),
                                  np.full(2, MAP_HALF, np.float32)),
            diffusion_radial_map=None, drift_speed_map=None,
            gains=jnp.zeros(N_CH, jnp.float32))
        xy = np.stack([case['x'], case['y']], 1)[e_inst]
        k1, k2 = jax.random.split(key)
        pat_e = np.asarray(js2.s2_pattern_map_diffuse(
            pj, kj, (k1, k2), None, jnp.asarray(case['z'][e_inst]),
            jnp.asarray(xy), jnp.arange(E), jnp.ones(E, bool)),
            dtype=np.float64)
        inside = pat_e.any(axis=1)          # the map's values are positive
        num = torch.zeros((I, pat_e.shape[1]), dtype=torch.float64)
        num = num.index_add_(0, torch.from_numpy(e_inst),
                             torch.from_numpy(pat_e)).numpy()
        den = np.bincount(e_inst, weights=inside, minlength=I)
        normals = [np.array(jax.random.normal(k, (E,))) for k in (k1, k2)]
        return num / np.maximum(den, 1.0)[:, None], normals
    return types.SimpleNamespace(jax=jax, run=run)


@pytest.mark.parametrize('name', DIFFUSE_CASES)
def test_pattern_diffuse_matches_jax(diffuse_jax, name):
    const = diffuse_constants()
    case = diffuse_case(name, const.tpc_radius)
    key = diffuse_jax.jax.random.key(DIFFUSE_CASES.index(name) + 200)
    pat_j, (n_r, n_a) = diffuse_jax.run(case, key)
    args = diffuse_args(case, const, n_r, n_a)
    pat_t = s2.pattern_diffuse(*args).numpy()
    assert pat_t.shape == (len(case['x']), N_CH)
    # wfsim_tpu's per-electron lookups summed in float64: one electron
    # dropped or added of 20,000 moves the mean by ~5e-5
    np.testing.assert_allclose(pat_t, pat_j, rtol=1e-6)
    empty = case['counts'] == 0
    assert not pat_t[empty].any()
    assert (pat_t[~empty] > 0).any(axis=1).sum() >= (~empty).sum() - 1
    if name == 'electrons outside the TPC radius':
        assert not pat_t[3].any()                 # every electron outside
    if name == 'a map with one output':
        assert (pat_t == pat_t[:, :1]).all()


@pytest.mark.parametrize('name', DIFFUSE_CASES)
def test_pattern_diffuse_matches_float64_mean(name):
    """The twin against a numpy float64 mean of its per-electron lookups
    over the inside electrons (numpy normals, as the card test)."""
    const = diffuse_constants()
    case = diffuse_case(name, const.tpc_radius)
    n_r, n_a = diffuse_normals(name, int(case['counts'].sum()))
    args = diffuse_args(case, const, n_r, n_a)
    gmap, x, y, std_r, std_a, ct, st, r2_max, edges = args[:9]
    e_inst = np.repeat(np.arange(len(case['x'])), case['counts'])
    hr = torch.from_numpy(n_r) * std_r[e_inst]
    ha = torch.from_numpy(n_a) * std_a[e_inst]
    xe = x[e_inst] + (hr * ct[e_inst] - ha * st[e_inst])
    ye = y[e_inst] + (hr * st[e_inst] + ha * ct[e_inst])
    inside = (xe * xe + ye * ye <= r2_max).numpy()
    pat = grid_lookup_ref(gmap.values, gmap.lows, gmap.highs,
                          torch.stack([xe, ye], 1)).numpy().astype(np.float64)
    pat = np.broadcast_to(pat.reshape(len(e_inst), -1), (len(e_inst), N_CH))
    want = np.zeros((len(case['x']), N_CH))
    np.add.at(want, e_inst[inside], pat[inside])
    want /= np.maximum(np.bincount(e_inst[inside],
                                   minlength=len(case['x'])), 1)[:, None]
    got = s2.pattern_diffuse(*args).numpy()
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-12,
                               atol=0)
    if name == 'electrons outside the TPC radius':
        assert 0 < (~inside).sum() < len(inside)


@pytest.mark.parametrize('name', DIFFUSE_CASES)
def test_pattern_diffuse_split_count(name):
    """``diffuse_chunks`` counts each instruction's chunks past its first
    (numpy's sum of (n - 1) // DIFFUSE_CHUNK); the CPU path gives the same
    pattern with that count and raises on any other."""
    const = diffuse_constants()
    case = diffuse_case(name, const.tpc_radius)
    n_r, n_a = diffuse_normals(name, int(case['counts'].sum()))
    args = diffuse_args(case, const, n_r, n_a)
    want = int((np.maximum(case['counts'] - 1, 0)
                // s2.DIFFUSE_CHUNK).sum())
    assert want == (9 if name == 'an instruction of 20,000 electrons' else 0)
    assert int(s2.diffuse_chunks(torch.as_tensor(case['counts']))) == want
    assert torch.equal(s2.pattern_diffuse(*args, want),
                       s2.pattern_diffuse(*args))
    with pytest.raises(ValueError, match='chunk count'):
        s2.pattern_diffuse(*args, want + 1)
