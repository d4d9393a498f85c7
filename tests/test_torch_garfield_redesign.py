"""K13c, the garfield wire-table luminescence times
(``csrc/table_samplers.cu wfsim_lumi_garfield_times``), on the CPU: a numpy
emulation of the kernel's decomposition against the unchanged twin
``lumi_garfield_times_ref``, and the wrapper's host checks.

The emulation follows the kernel: tiles of 4,096 photons; each tile's
first and last instructions from the clamped edges (the warps' searches),
the edges inside it counted for each photon (``TileIds``); the rows of
instructions s0 .. s0 + m computed a lane each where at most kRegEdges
(8) edges lie inside the tile and read by the photon's count, else
computed for each photon's instruction; the row itself by the kernel's
loop (float32 rotation and remainder, a strict < over x_axis in index
order); t = int(table[row, col]) - avgt; photons past the last clamped
edge not written.  tests/test_torch_cuda.py holds the card's kernel to
the twin on the same cases.  The parity of the twin with wfsim_tpu is in
tests/test_torch_timing_models.py.

Tolerances: bitwise.
"""
import numpy as np
import pytest
import torch

from wfsim_tpu_torch.models import s2
from wfsim_tpu_torch.models.params import table_mean_int
from wfsim_tpu_torch.resources.synthetic import synthetic_garfield_table

TILE = 4096
REG_EDGES = 8

#: name: (instruction photon counts, confine); 'skewed' has one
#: instruction of 10^6 photons, 'tiny' tiles of hundreds of instructions
#: (more than REG_EDGES edges inside: the per-photon rows), 'ties' an
#: x_axis with repeated values and confine-mode distances exactly between
#: two rows
GARFIELD_CASES = {
    'bench': ('bench', -1.0),
    'bench_confine': ('bench', 0.1),
    'skewed': ('skewed', -1.0),
    'empty': ('empty', -1.0),
    'tiny': ('tiny', 0.1),
    'ties_wire': ('ties', -1.0),
    'ties_confine': ('ties', 0.25),
}


def garfield_case(name, seed=11):
    """(table, x_axis, xy, ph_edges, cols, u_wire, kw) of a GARFIELD_CASES
    case, numpy arrays (kw: avgt, tilt, pitch, confine)."""
    kind, confine = GARFIELD_CASES[name]
    rng = np.random.default_rng(seed + len(name))
    tbl = synthetic_garfield_table(3)
    table, x_axis = tbl['t'], tbl['x']
    if kind == 'bench':
        counts = rng.poisson(3070, 512)
    elif kind == 'skewed':
        counts = rng.poisson(3070, 512)
        counts[100] = 1_000_000
        counts[[3, 200, 511]] = 0
    elif kind == 'empty':
        counts = rng.poisson(300, 256) * (rng.random(256) < 0.5)
        counts[:5] = 0
        counts[-7:] = 0
        counts[60:90] = 0
    elif kind == 'tiny':
        counts = rng.integers(0, 4, 20_000)
        counts[5000] = 9000
    else:
        counts = rng.poisson(700, 64)
        x_axis = np.array([-0.25, -0.125, -0.125, 0.0, 0.0, 0.125, 0.25,
                           0.25, 0.25, 0.375, 0.5], np.float32)
    n_i = len(counts)
    n = int(counts.sum())
    xy = rng.uniform(-60, 60, (n_i, 2)).astype(np.float32)
    xy[:4] = [[0, 0], [0.25, -0.25], [-0.7071, 0.7071], [12, -7]]
    u_wire = None
    if confine > 0:
        u_wire = rng.random(n_i).astype(np.float32)
        if kind == 'ties':
            # d = u * 2c - c at 0.0625 and -0.0625: between rows 3 and 5,
            # 1 and 3 (|d - x| equal in float32)
            u_wire[::3] = 0.625
            u_wire[1::3] = 0.375
    cols = rng.integers(0, table.shape[1], n)
    kw = dict(avgt=table_mean_int(table), tilt=np.pi / 4, pitch=0.5,
              confine=confine)
    return (table, x_axis, xy, np.concatenate([[0], np.cumsum(counts)]),
            cols, u_wire, kw)


def torch_args(case):
    *arrays, u_wire, kw = case
    args = [torch.as_tensor(a) for a in arrays]
    return args, (None if u_wire is None else torch.as_tensor(u_wire)), kw


def row_of(d, x_axis):
    """The kernel's row loop: argmin |d - x_r| by a strict < in index
    order, float32."""
    best_r, best = 0, np.float32(abs(np.float32(d - x_axis[0])))
    for r in range(1, len(x_axis)):
        diff = np.float32(abs(np.float32(d - x_axis[r])))
        if diff < best:
            best, best_r = diff, r
    return best_r


def wire_distance(i, xy, u_wire, kw):
    """The distance d of instruction i as the kernel computes it."""
    f = np.float32
    c = f(kw['confine'])
    if u_wire is not None:
        return max(-c, f(f(u_wire[i] * f(c + c)) + -c))
    s, co = s2.tilt_coefficients(kw['tilt'])
    rot_y = f(f(xy[i, 0] * f(s)) + f(xy[i, 1] * f(co)))
    p, half = f(kw['pitch']), f(kw['pitch'] / 2)
    r = np.fmod(f(rot_y + half), p)
    if r != 0 and ((r < 0) != (p < 0)):
        r = f(r + p)
    return f(r - half)


def garfield_row(i, xy, u_wire, x_axis, kw):
    """The row of instruction i as the kernel computes it."""
    return row_of(wire_distance(i, xy, u_wire, kw), x_axis)


def emulate_garfield(table, x_axis, xy, ph_edges, cols, u_wire, kw):
    """(t, stats) as the kernel computes them (see the module docstring);
    t holds -1 where nothing was written; stats: tiles, tiles whose rows
    came from lanes, rows computed."""
    n = len(cols)
    S = len(ph_edges) - 1
    e = np.minimum(ph_edges, n)                     # the clamped edges
    t = np.full(n, -1, np.int64)
    stats = dict(tiles=0, lane_tiles=0, rows=0)
    for a in range(0, n, TILE):
        b = min(a + TILE, n)
        s0 = int(np.searchsorted(e, a, side='right')) - 1
        s1 = int(np.searchsorted(e, b - 1, side='right')) - 1
        if s0 == s1 and not 0 <= s0 < S:
            continue
        stats['tiles'] += 1
        pos = np.arange(a, b)
        # the segment of each photon: s0 plus the edges inside at or before
        rel = np.searchsorted(e[s0 + 1:s1 + 1], pos, side='right')
        seg = s0 + rel
        ok = (seg >= 0) & (seg < S)
        if s1 - s0 <= REG_EDGES:
            stats['lane_tiles'] += 1
            lane_row = [garfield_row(s0 + k, xy, u_wire, x_axis, kw)
                        if 0 <= s0 + k < S else 0
                        for k in range(s1 - s0 + 1)]
            stats['rows'] += len(lane_row)
            rows = np.asarray(lane_row)[rel]
        else:
            uniq = np.unique(seg[ok])
            by = {i: garfield_row(i, xy, u_wire, x_axis, kw) for i in uniq}
            stats['rows'] += len(uniq)
            rows = np.array([by.get(i, 0) for i in seg])
        v = table[rows, cols[a:b]].astype(np.int32) - kw['avgt']
        t[a:b][ok] = v[ok]
    return t, stats


@pytest.mark.parametrize('name', sorted(GARFIELD_CASES))
def test_garfield_emulation_matches_twin(name):
    """Tile instructions and rows: the bench batch in both modes, one
    instruction of 10^6 photons, empty instructions, tiles of hundreds of
    instructions, ties in x_axis and in |d - x_r|."""
    case = garfield_case(name)
    args, u_wire, kw = torch_args(case)
    want = s2.lumi_garfield_times_ref(*args, u_wire, **kw).numpy()
    got, stats = emulate_garfield(*case)
    np.testing.assert_array_equal(got, want)
    assert stats['tiles'] == -(-len(got) // TILE)
    if name in ('tiny', 'empty'):      # runs of empty instructions
        assert stats['lane_tiles'] < stats['tiles']
    else:
        assert stats['lane_tiles'] == stats['tiles']
    if name == 'skewed':
        # ~245 tiles of the one instruction, one row each
        assert stats['rows'] < 2 * stats['tiles']


@pytest.mark.parametrize('name', ['ties_wire', 'ties_confine'])
def test_garfield_row_loop_matches_argmin(name):
    """The kernel's strict-< row loop is torch's argmin (lowest index on a
    tie) on every instruction of the tie cases, and the ties occur."""
    table, x_axis, xy, _e, _c, u_wire, kw = garfield_case(name)
    d = np.array([wire_distance(i, xy, u_wire, kw) for i in range(len(xy))],
                 np.float32)
    rows = [row_of(x, x_axis) for x in d]
    want = torch.argmin(torch.abs(torch.as_tensor(d)[:, None]
                                  - torch.as_tensor(x_axis)[None]),
                        dim=1).numpy()
    assert rows == want.tolist()
    dist = np.abs(d[:, None] - x_axis[None])
    n_ties = int(((dist == dist.min(1, keepdims=True)).sum(1) > 1).sum())
    assert n_ties > 10


def test_garfield_wrapper_checks_on_cpu():
    """The host checks: edges that do not end at the columns' count,
    photons without instructions, positions of another length."""
    table, x_axis, xy, edges, cols, _u, kw = garfield_case('bench')
    args, _u, kw = torch_args((table, x_axis, xy, edges, cols, None, kw))
    with pytest.raises(ValueError, match='edges end'):
        s2.lumi_garfield_times(*args[:4], args[4][:-1], **kw)
    with pytest.raises(ValueError, match='shape'):
        s2.lumi_garfield_times(args[0], args[1], args[2][:-1], *args[3:],
                               **kw)
    with pytest.raises(ValueError, match='edges end'):
        s2.lumi_garfield_times(args[0], args[1], args[2][:0],
                               torch.zeros(1, dtype=torch.int64), args[4],
                               **kw)
    t = s2.lumi_garfield_times(*args, **kw)
    assert torch.equal(t, s2.lumi_garfield_times_ref(*args, **kw))
