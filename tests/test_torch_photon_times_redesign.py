"""The flat kernels of the gas-gap luminescence times
(``wfsim_lumi_gasgap_times``, K13a, ``csrc/table_samplers.cu``) and of the
S2 electron and photon times (``wfsim_s2_electron_times`` and
``wfsim_s2_photon_times``, K9, ``csrc/photon_times.cu``), emulated in numpy
and held against their unchanged plain twins.

The S2 time kernels cut the work by elements: a block takes a fixed tile
of elements (4,096 photons, 1,024 electrons), finds the segments of its first
and last element once and gives every element its segment from the edges
inside the tile: by counting those at or before it where there are at
most eight, else by a max-scan of their marks (``csrc/tiles.cuh``); the
photon kernel finds a photon's electron and instruction that way, from the
electrons' photon edges and the instructions' first photons.  The gas-gap
sampler takes an instruction whose photons fit 8,192 from its first photon
rounded down to a multiple of four in one block (a block reduction of its
fixed-point times, int64 multiples of 2^-32 ns); a larger one ("tiled")
is listed, and its tile passes cut it into tiles of 4,096 photons from
that rounded first photon: the sum pass adds each tile's sum to the
instruction's by a wrapping integer atomic, the apply pass's tiles read
the sum and take a ticket each, and the one that completes an
instruction clears its sum.  The emulation here does the same
decomposition (``tile_segments``, ``photon_segments``, ``tiled_tiles``)
under three tile sizes, with the kernel's block span and with every
instruction tiled, and adds the contributions tile by tile in shuffled
orders; tests/test_torch_cuda.py holds the card's outputs to the twins on
the same cases.

The cases are numpy only, made from a seed (``photon_case``), so that the
card's machine, which has no JAX, can import them; the parity tests
against wfsim_tpu import JAX inside themselves.
"""
import math
import types

import numpy as np
import pytest
import torch

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models import s2
from wfsim_tpu_torch.models.params import (build_constants, build_params,
                                           gasgap_time_max)
from wfsim_tpu_torch.ops.segment import segment_ids_from_counts
from wfsim_tpu_torch.resources import load_config
from wfsim_tpu_torch.resources.synthetic import synthetic_garfield_gas_gap

#: tile sizes the emulation cuts the photons into: the kernels' 4,096
#: (table_samplers.cu kTile, photon_times.cu kPhotonSteps) and two others,
#: so that the tiles' boundaries fall elsewhere
TILES = (2048, 4096, 8192)
KERNEL_TILE = 4096
#: photons an instruction block of the gas-gap sampler takes at most, from
#: its first photon rounded down to a multiple of four (table_samplers.cu
#: kBlockSpan); with 0 every instruction with photons is tiled
BLOCK_SPAN = 8192
KERNEL_REG_EDGES = 8     # tiles.cuh kRegEdges: edges a tile finds in registers
PHOTON_CASES = (
    'bench',                 # 512 instructions, ~176 electrons, ~3,076 photons
    'one instruction of 10^6',
    'one electron of 10^5',
    'empty instructions',    # instructions without photons
    'no electrons',          # instructions without electrons
    'electrons without photons',
    'tile edges',            # electron and instruction edges on tile edges
    'u = 1 - 2^-24',
    'tiny instructions',     # one of ~20,000 photons among 1-electron ones
    'many just past',        # every instruction just past 8,192 photons
)
U_TOP = np.float32(1 - 2 ** -24)


def photon_case(name, seed=20261017):
    """An S2 batch: ``e_counts`` (I,) electrons an instruction, ``ph_counts``
    (E,) photons an electron, every per-instruction, per-electron and
    per-photon input of the two kernels and the gas-gap sampler, as numpy
    arrays made from ``seed``."""
    rng = np.random.default_rng(seed)
    I = 512 if name == 'bench' else 40
    e_counts = rng.poisson(176, I)
    if name == 'no electrons':
        e_counts[[0, 7, 8, I - 1]] = 0
    E = int(e_counts.sum())
    ph_counts = rng.poisson(17.5, E)
    e_edges = np.concatenate([[0], np.cumsum(e_counts)])
    if name == 'one instruction of 10^6':
        big = np.full(57_143, 17)
        big[11] += 1_000_000 - int(big.sum())
        ph_counts = np.concatenate([ph_counts[:e_edges[3]], big,
                                    ph_counts[e_edges[4]:]])
        e_counts[3] = len(big)
    if name == 'one electron of 10^5':
        ph_counts[e_edges[5] + 2] = 100_000
    if name == 'tiny instructions':
        # instructions 3-30 of one electron each around instruction 16 of
        # ~1,150 electrons: the tiles at its ends hold more than eight edges
        e_counts[3:31] = 1
        e_counts[16] = 1150
        ph_counts = rng.poisson(17.5, int(e_counts.sum()))
    if name == 'empty instructions':
        for i in (0, 4, 5, I - 1):
            ph_counts[e_edges[i]:e_edges[i + 1]] = 0
        # instruction 6, after two empty ones, past the gas-gap sampler's
        # instruction block
        ph_counts[e_edges[6]:e_edges[7]] *= 4
    if name == 'electrons without photons':
        ph_counts[rng.random(len(ph_counts)) < 0.2] = 0
        ph_counts[e_edges[2]:e_edges[2] + 40] = 0
    if name == 'tile edges':
        # an electron edge at 8,192 and instruction edges at 16,384 and
        # 32,768, tile edges of every tile size: instructions 0 and 3 are
        # past the gas-gap sampler's instruction block, so its tiles meet
        # them there
        ph_counts = _end_at(ph_counts, 5, 8192)
        ph_counts = _end_at(ph_counts, e_edges[1] - 1, 16_384)
        ph_counts = _end_at(ph_counts, e_edges[4] - 1, 32_768)
    e_edges = np.concatenate([[0], np.cumsum(e_counts)])
    if name == 'many just past':
        # instruction i ends at 8,300 (i + 1) + 7 i: each is past the
        # gas-gap sampler's instruction block, 3 of its tiles, 120 tiles
        # against a grid of 82 blocks
        for i in range(I):
            ph_counts = _end_at(ph_counts, e_edges[i + 1] - 1,
                                8300 * (i + 1) + 7 * i)
    e_ph_edges = np.concatenate([[0], np.cumsum(ph_counts)])
    n, E = int(e_ph_edges[-1]), int(e_edges[-1])
    if name == 'tile edges':
        assert e_ph_edges[e_edges[1]] == 16_384 and 8192 in e_ph_edges
        assert e_ph_edges[e_edges[4]] == 32_768
    f32 = np.float32
    u_lum = rng.random(n, dtype=f32)
    if name == 'u = 1 - 2^-24':
        u_lum[::7] = U_TOP
        u_lum[3::11] = 0.0
    gg = synthetic_garfield_gas_gap()
    gaps = gg['gas_gap'].astype(f32)
    # gas gaps below, inside and above the table's
    gap = rng.uniform(gaps[0] - 0.02, gaps[-1] + 0.02, I).astype(f32)
    return dict(
        I=I, E=E, n=n, e_counts=e_counts, ph_counts=ph_counts,
        e_edges=e_edges, e_ph_edges=e_ph_edges,
        ph_edges=e_ph_edges[e_edges],
        time=rng.integers(0, 10 ** 8, I).astype(np.int32),
        mean=rng.uniform(0, 2e5, I).astype(f32),
        spread=rng.uniform(0, 300, I).astype(f32),
        e_exp=rng.exponential(size=E).astype(f32),
        e_normal=rng.normal(size=E).astype(f32),
        truth_row=np.sort(rng.integers(0, I // 2, I)).astype(np.int64),
        e_t=rng.integers(0, 10 ** 8, E).astype(np.int32),
        u_lum=u_lum, u_st=rng.random(n, dtype=f32),
        exp_st=rng.exponential(size=n).astype(f32),
        t_spread=rng.normal(size=n).astype(f32),
        t_lum=rng.integers(-300, 300, n).astype(np.int32),
        gg_inv_cdf=gg['timing_inv_cdf'].astype(f32), gaps=gaps, gap=gap)


def _end_at(ph_counts, k, total):
    """``ph_counts`` with electron k's count changed so that the photons of
    electrons 0..k end at ``total``."""
    out = ph_counts.copy()
    out[k] += total - int(out[:k + 1].sum())
    assert out[k] >= 0
    return out


def gasgap_rows_np(c):
    """The gas-gap sampler's per-instruction rows and fraction, as
    ``s2.gasgap_rows`` takes them from the looked-up gaps ``c['gap']``."""
    gaps = torch.as_tensor(c['gaps'])
    gg = torch.as_tensor(c['gap'])
    G = gaps.shape[0]
    ind = torch.clamp(torch.searchsorted(gaps, gg, right=True) - 1, 0, G - 1)
    upper = torch.clamp(ind + 1, 0, G - 1)
    frac = (gg - gaps[ind]) / (gaps[1:2] - gaps[0:1])
    return ind.numpy(), upper.numpy(), frac.numpy()


def gasgap_args(c):
    """The gas-gap sampler's inputs as CPU tensors."""
    lower, upper, frac = gasgap_rows_np(c)
    return tuple(torch.as_tensor(a) for a in (
        c['gg_inv_cdf'], lower, upper, frac, c['ph_edges'], c['u_lum']))


def photon_args(c, lum='inv', spread=True):
    """The photon kernel's inputs as CPU tensors and keywords: the simple
    model's tables (``lum`` 'inv') or given luminescence times ('t_lum');
    with the time spread or without."""
    const = build_constants(default_config())
    inv = s2.luminescence_tables(const, c['I'], 'cpu')
    t = {k: torch.as_tensor(c[k]) for k in (
        'e_edges', 'e_ph_edges', 'e_t', 'truth_row', 'u_lum', 'u_st',
        'exp_st', 't_spread', 't_lum')}
    kw = dict(singlet_fraction=const.singlet_fraction_gas,
              t_singlet=const.singlet_lifetime_gas,
              t_triplet=const.triplet_lifetime_gas, time_spread=25.0,
              t_lum=t['t_lum'] if lum == 't_lum' else None)
    args = (inv if lum == 'inv' else None, t['e_edges'], t['e_ph_edges'],
            t['e_t'], t['truth_row'], t['u_lum'] if lum == 'inv' else None,
            t['u_st'], t['exp_st'], t['t_spread'] if spread else None)
    return args, kw


def electron_args(c):
    """The electron kernel's inputs as CPU tensors and keywords."""
    const = build_constants(default_config())
    args = tuple(torch.as_tensor(c[k]) for k in (
        'time', 'e_edges', 'mean', 'spread', 'e_exp', 'e_normal',
        'truth_row'))
    return args, dict(trapping=const.electron_trapping_time)


# ---------------------------------------------------------------------------
# the kernels' decomposition in numpy


def tile_range(e, a, b):
    """The segments of a tile's first and last elements, a and b - 1, as the
    kernels' warp search finds them: the count of clamped edges at or
    below each, minus one."""
    return (int(np.searchsorted(e, a, 'right')) - 1,
            int(np.searchsorted(e, b - 1, 'right')) - 1)


def scan_marks(tile, a, lo, hi, pos, base):
    """The segments of a tile's positions from the edges s in (lo, hi] at
    pos(s) - a, as ``base`` plus the max-scan of their marks (s - lo at its
    position, the largest where several share one) and, where there are at
    most ``KERNEL_REG_EDGES``, as the kernels find them in registers:
    ``base`` plus the count of edges at or before the position."""
    marks = np.zeros(tile, np.int64)
    s = np.arange(lo + 1, hi + 1)
    np.maximum.at(marks, pos(s) - a, s - lo)
    out = base + np.maximum.accumulate(marks)
    if hi - lo <= KERNEL_REG_EDGES:
        counted = base + (np.arange(tile)[:, None]
                          >= (pos(s) - a)[None, :]).sum(axis=1)
        np.testing.assert_array_equal(counted, out)
    return out


def tile_segments(edges, n, tile):
    """Each element's segment as the kernels find it, tile by tile (S past
    the clamped last edge; the last tile padded to a whole tile)."""
    e = np.minimum(edges, n)
    out = np.empty(-(-n // tile) * tile, np.int64)
    for a in range(0, n, tile):
        s0, s1 = tile_range(e, a, min(a + tile, n))
        out[a:a + tile] = scan_marks(tile, a, s0, s1, lambda s: e[s], s0)
    return out


def photon_segments(e_edges, e_ph_edges, n, tile):
    """Each photon's (electron, instruction) as the photon kernel finds
    them: the tile's electrons by the photon edges, its instructions by the
    electron edges of its first and last electrons, then the electrons'
    photon edges and the instructions' first photons marked inside the
    tile."""
    E = len(e_ph_edges) - 1
    eph, ee = np.minimum(e_ph_edges, n), np.minimum(e_edges, E)
    k = np.empty(-(-n // tile) * tile, np.int64)
    i = np.empty_like(k)
    for a in range(0, n, tile):
        k0, k1 = tile_range(eph, a, min(a + tile, n))
        i0 = int(np.searchsorted(ee, k0, 'right')) - 1
        i1 = int(np.searchsorted(ee, k1, 'right')) - 1
        k[a:a + tile] = scan_marks(tile, a, k0, k1, lambda s: eph[s], k0)
        i[a:a + tile] = scan_marks(tile, a, i0, i1, lambda s: eph[ee[s]], i0)
    return k, i


def gasgap_times_np(inv, lower, upper, frac, ids, u):
    """Each photon's T and its fixed-point term (uint64, wrapping), with
    the kernel's float32 steps (each product and sum rounded); 0 where the
    photon has no instruction."""
    f = np.float32
    ok = (ids >= 0) & (ids < len(lower))
    idc = np.where(ok, ids, 0)
    M = inv.shape[1]
    s = u * f(M - 2)
    i0, i1 = np.floor(s).astype(np.int64), np.ceil(s).astype(np.int64)
    w = s - i0.astype(f)
    lo, hi, fr = lower[idc], upper[idc], frac[idc]

    def grab(c):
        a = inv[lo, c]
        return (inv[hi, c] - a) * fr + a
    t1, t2 = grab(i0), grab(i1)
    T = (t2 - t1) * w + t1
    x = np.rint(T.astype(np.float64) * 2.0 ** 32).astype(np.int64)
    return T, np.where(ok, x, 0).view(np.uint64)


def tiled_np(edges, n, span):
    """(S,) bool: the instructions the gas-gap sampler's instruction blocks
    list for its tile passes,
    those whose photons [lo, hi) (edges clamped to n) do not fit ``span``
    from lo rounded down to a multiple of four (an empty one fits any)."""
    e = np.minimum(edges, n)
    return (e[1:] > e[:-1]) & (e[1:] > (e[:-1] & ~3) + span)


def tiled_tiles(edges, n, tile, order):
    """The tile passes' tiles in the grid's order: the tiled instructions
    in list order ``order``, each cut into tiles of ``tile`` photons from
    its first photon rounded down to a multiple of four: [(instruction,
    the tile's first position, the instruction's count of tiles), ...]."""
    e = np.minimum(edges, n)
    out = []
    for i in order:
        a = int(e[i]) & ~3
        k = -(-(int(e[i + 1]) - a) // tile)
        out += [(int(i), a + tile * j, k) for j in range(k)]
    return out


def emulate_gasgap(edges, n, tile, x, tiled, rng):
    """The tile passes with the list in a shuffled order (the instruction
    blocks' atomics give any): the sum pass's tiles, in a shuffled order,
    add the sums of their photons' fixed-point terms ``x`` (uint64,
    wrapping; adds of 0 skipped) to their instructions' sums; the apply
    pass's, in another, read the sum and take a ticket, and the one that
    completes the instruction's tiles clears its sum and ticket.  Returns
    (the sums the tiles read, as int64: one list an instruction; the
    scratch left behind: sums and tickets; the strides of the grid of a
    block a tile of the photons over the tiles)."""
    S = len(edges) - 1
    e = np.minimum(edges, n)
    tl = tiled_tiles(edges, n, tile, rng.permutation(np.flatnonzero(tiled)))
    sums, tickets = [0] * S, [0] * S
    for b in rng.permutation(len(tl)):
        i, a, _k = tl[b]
        v = int(x[max(a, int(e[i])):min(a + tile, int(e[i + 1]))]
                .sum(dtype=np.uint64))
        if v:
            sums[i] = (sums[i] + v) % 2 ** 64
    read = [[] for _ in range(S)]
    for b in rng.permutation(len(tl)):
        i, _a, k = tl[b]
        read[i].append(sums[i] - 2 ** 64 if sums[i] >= 2 ** 63 else sums[i])
        tickets[i] += 1
        if tickets[i] == k:
            sums[i] = tickets[i] = 0
    strides = -(-len(tl) // -(-n // tile)) if n else 0
    return read, (np.array(sums), np.array(tickets)), strides


def means_np(sums, counts):
    """The mean of each instruction from its fixed-point sum, as the
    kernel and the twin compute it."""
    c = np.maximum(counts, 1).astype(np.float64)
    return (sums.astype(np.float64) / 2.0 ** 32 / c).astype(np.float32)


# ---------------------------------------------------------------------------
# the emulation against the twins


_CASES = {}


def case(name):
    if name not in _CASES:
        _CASES[name] = photon_case(name)
    return _CASES[name]


_REFS = {}


def gasgap_ref(name):
    """The gas-gap twin's times on case ``name`` (computed once)."""
    if name not in _REFS:
        _REFS[name] = s2.lumi_gasgap_times_ref(*gasgap_args(case(name)))
    return _REFS[name]


@pytest.mark.parametrize('tile', TILES)
@pytest.mark.parametrize('name', PHOTON_CASES)
def test_tile_segments_match_segment_ids(name, tile):
    """Every photon's electron and instruction (the photon tiles) and every
    electron's instruction (the electron tiles) as the kernels find them:
    the twins' segment ids."""
    c = case(name)
    n, E = c['n'], c['E']
    ph_e = segment_ids_from_counts(torch.as_tensor(c['ph_counts'])).numpy()
    e_inst = segment_ids_from_counts(torch.as_tensor(c['e_counts'])).numpy()
    k, i = photon_segments(c['e_edges'], c['e_ph_edges'], n, tile)
    np.testing.assert_array_equal(k[:n], ph_e)
    np.testing.assert_array_equal(i[:n], e_inst[ph_e])
    np.testing.assert_array_equal(tile_segments(c['e_edges'], E, 1024)[:E],
                                  e_inst)


@pytest.mark.parametrize('tile,span', [(2048, BLOCK_SPAN),
                                       (KERNEL_TILE, BLOCK_SPAN),
                                       (8192, BLOCK_SPAN), (KERNEL_TILE, 0)])
@pytest.mark.parametrize('name', PHOTON_CASES)
def test_gasgap_sums_in_any_order_match_twin(name, tile, span):
    """The gas-gap sampler's sums: an instruction block's is the exact sum
    of its fixed-point terms; the tile passes' adds, tile by tile in
    shuffled orders with the list in a shuffled order, give each tiled
    instruction that exact sum, which every apply tile of it reads, and
    the tickets leave the scratch zero; the means and times from them are
    the twin's, bitwise.  With the kernel's block span (the bench's
    instructions all fit it; the large ones of the other cases do not;
    the grid of a block a tile of the photons strides over the tiles at
    most twice) and with every instruction tiled."""
    c = case(name)
    n = c['n']
    lower, upper, frac = gasgap_rows_np(c)
    counts = c['ph_edges'][1:] - c['ph_edges'][:-1]
    ids = segment_ids_from_counts(torch.as_tensor(counts)).numpy()
    T, x = gasgap_times_np(c['gg_inv_cdf'], lower, upper, frac, ids,
                           c['u_lum'])
    exact = np.zeros(c['I'], np.int64)
    np.add.at(exact, ids, x.view(np.int64))
    tiled = tiled_np(c['ph_edges'], n, span)
    if span == 0:
        assert tiled.sum() == (counts > 0).sum()
    elif name == 'bench':
        assert not tiled.any()
    elif name in ('one instruction of 10^6', 'one electron of 10^5',
                  'tiny instructions'):
        assert tiled.sum() == 1
    for seed in (1, 2):
        read, (left, tickets), strides = emulate_gasgap(
            c['ph_edges'], n, tile, x, tiled, np.random.default_rng(seed))
        for i in range(c['I']):
            lo = int(c['ph_edges'][i]) & ~3
            tiles = -(-(int(c['ph_edges'][i + 1]) - lo) // tile)
            assert read[i] == ([int(exact[i])] * tiles if tiled[i] else []), i
        assert not left.any() and not tickets.any()
        if span:
            assert strides <= 2
        if name == 'many just past' and (tile, span) == (KERNEL_TILE,
                                                          BLOCK_SPAN):
            assert tiled.all() and strides == 2
    t = np.trunc(T - means_np(exact, counts)[ids]).astype(np.int32)
    np.testing.assert_array_equal(t, gasgap_ref(name).numpy())


@pytest.mark.parametrize('name', PHOTON_CASES)
def test_photon_times_emulation_matches_twin(name):
    """The photon kernel's arithmetic from the photons' (electron,
    instruction) as its tiles find them, in both luminescence modes and
    without the time spread: the twin's times and truth rows, bitwise."""
    c = case(name)
    n = c['n']
    k, i = photon_segments(c['e_edges'], c['e_ph_edges'], n, KERNEL_TILE)
    k, i = k[:n], i[:n]
    for lum, spread in (('inv', True), ('t_lum', True), ('inv', False)):
        args, kw = photon_args(c, lum, spread)
        t, row = s2.s2_photon_times_ref(*args, **kw)
        f = np.float32
        if lum == 'inv':
            inv = args[0].numpy()
            uq = c['u_lum'] * f(s2.Q - 1)
            lo = np.minimum(np.floor(uq).astype(np.int64), s2.Q - 2)
            w = uq - lo.astype(f)
            tt = np.trunc(inv[i, lo] * (f(1) - w)
                          + inv[i, lo + 1] * w).astype(np.int32)
        else:
            tt = c['t_lum'].copy()
        life = np.where(c['u_st'] < f(kw['singlet_fraction']),
                        f(kw['t_singlet']), f(kw['t_triplet']))
        tt = tt + np.trunc(c['exp_st'] * life).astype(np.int32)
        if spread:
            tt = tt + np.trunc(c['t_spread'] * f(25.0)).astype(np.int32)
        tt = tt + c['e_t'][k]
        np.testing.assert_array_equal(tt, t.numpy())
        np.testing.assert_array_equal(c['truth_row'][i], row.numpy())


def test_twins_return_times_and_rows():
    """The S2 time twins return the times and the truth rows only (no
    caller read the segment ids)."""
    c = case('empty instructions')
    args, kw = photon_args(c)
    t, row = s2.s2_photon_times(*args, **kw)
    assert t.dtype == torch.int32 and row.dtype == torch.int64
    e_args, e_kw = electron_args(c)
    e_t, e_row = s2.s2_electron_times(*e_args, **e_kw)
    inst = segment_ids_from_counts(torch.as_tensor(c['e_counts']))
    assert torch.equal(e_row, torch.as_tensor(c['truth_row'])[inst])
    assert e_t.shape == (c['E'],)


# ---------------------------------------------------------------------------
# the gas-gap sampler's range check without a read-back


def _map_of(values):
    from wfsim_tpu_torch.ops.interp import GridMap
    ax = np.linspace(-60, 60, values.shape[0])
    return GridMap.from_axes(values, (ax, np.linspace(-60, 60,
                                                      values.shape[1])))


def test_gasgap_bound_never_below_exact_check():
    """``gasgap_time_max`` of the table and the map's values, times the
    photon total, is never below ``check_fixed_point_range``'s worst sum,
    over random tables (times of either sign), maps whose gaps lie below,
    inside and above the table's, positions inside and outside the map and
    random counts; so skipping the check where the bound fits never skips a
    raise.  A hypothesis property (skipped where hypothesis is not
    installed)."""
    hyp = pytest.importorskip('hypothesis')
    st = pytest.importorskip('hypothesis.strategies')

    @hyp.settings(max_examples=150, deadline=None)
    @hyp.given(data=st.data())
    def check(data):
        G = data.draw(st.integers(2, 12))
        M = data.draw(st.integers(3, 40))
        seed = data.draw(st.integers(0, 2 ** 32 - 1))
        rng = np.random.default_rng(seed)
        scale = 10.0 ** rng.uniform(-2, 6)
        inv = (rng.normal(0, scale, (G, M))
               + rng.uniform(-1, 2) * scale).astype(np.float32)
        g0, dg = rng.uniform(0.01, 0.2), rng.uniform(0.001, 0.05)
        gaps = (g0 + dg * np.arange(G) + rng.uniform(0, 0.3 * dg, G)
                * data.draw(st.sampled_from([0.0, 1.0]))).astype(np.float32)
        gaps.sort()
        lo = gaps[0] - rng.uniform(0, 5) * dg
        hi = gaps[-1] + rng.uniform(0, 5) * dg
        values = rng.uniform(lo, hi,
                             (rng.integers(2, 6), rng.integers(2, 6)))
        gmap = _map_of(values.astype(np.float32))
        I = data.draw(st.integers(1, 20))
        xy = torch.as_tensor(rng.uniform(-80, 80, (I, 2)),
                             dtype=torch.float32)
        prm = types.SimpleNamespace(garfield_gas_gap_map=gmap,
                                    gg_gas_gap=torch.as_tensor(gaps))
        lower, upper, frac = s2.gasgap_rows(prm, xy)
        counts = rng.integers(0, 10 ** rng.integers(1, 9), I)
        edges = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
        inv_t = torch.as_tensor(inv)
        t_max = ((inv_t[upper, :M - 1] - inv_t[lower, :M - 1])
                 * frac[:, None] + inv_t[lower, :M - 1]).abs().amax(dim=1)
        worst = float(((edges[1:] - edges[:-1]) * t_max).max())
        bound = gasgap_time_max(inv, gaps, gmap.values.numpy())
        assert int(counts.sum()) * bound >= worst
        if not s2.fixed_point_fails(int(counts.sum()) * bound):
            s2.check_fixed_point_range(inv_t, lower, upper, frac, edges)
    check()


def test_gasgap_bound_of_the_detector_physics_table():
    """The bound ``build_params`` keeps for the synthetic table and the
    constant map (the mean gap, between the rows of 0.09 and 0.10 cm): at
    least every time the sampler can give there and at most the upper
    row's largest (125 ns), so a batch of 10^6 photons needs no
    read-back."""
    cfg = default_config(s2_luminescence_model='garfield_gas_gap')
    params = build_params(cfg, load_config(cfg), 'cpu')
    xy = torch.zeros((1, 2))
    lower, upper, frac = s2.gasgap_rows(params, xy)
    assert (int(lower), int(upper)) == (4, 5)
    inv = params.gg_inv_cdf
    t = ((inv[upper, :-1] - inv[lower, :-1]) * frac[:, None]
         + inv[lower, :-1]).abs().max()
    assert float(t) <= params.gg_t_max <= float(inv[5, :-1].max())
    assert not s2.fixed_point_fails(10 ** 6 * params.gg_t_max)


@pytest.mark.parametrize('n_photons,fits', [(2100, True), (2200, False)])
def test_gasgap_range_with_bound(n_photons, fits):
    """With the host bound given, the cases of
    test_gasgap_mean_fixed_point_range behave as without it: 2,100 photons
    at 1 ms fit the bound (no exact check) and give the exact mean; 2,200
    fail it, and the exact check raises."""
    inv = torch.full((2, 16), 1e6)
    args = (inv, torch.tensor([0, 0]), torch.tensor([1, 1]),
            torch.tensor([0.3, 0.7]), torch.tensor([0, 5, 5 + n_photons]),
            torch.rand(5 + n_photons, generator=torch.Generator()
                       .manual_seed(3)))
    t_max = gasgap_time_max(inv.numpy(), np.array([0.1, 0.2], np.float32),
                            np.array([0.13, 0.17]))
    assert s2.fixed_point_fails((5 + n_photons) * t_max) is not fits
    if fits:
        assert not s2.lumi_gasgap_times(*args, t_max=t_max).any()
    else:
        with pytest.raises(OverflowError):
            s2.lumi_gasgap_times(*args, t_max=t_max)


def test_cpu_paths_check_edges():
    """On the CPU the three wrappers raise where the edges do not end at
    the elements (on the card the kernels clamp them: no read-back)."""
    c = case('empty instructions')
    g = list(gasgap_args(c))
    g[4] = g[4].clone()
    g[4][-1] += 1
    with pytest.raises(ValueError, match='uniforms: the edges end at'):
        s2.lumi_gasgap_times(*g, t_max=math.inf)
    args, kw = photon_args(c)
    bad = list(args)
    bad[2] = bad[2].clone()
    bad[2][-1] -= 1
    with pytest.raises(ValueError, match='photon draws: the edges end at'):
        s2.s2_photon_times(*bad, **kw)
    bad = list(args)
    bad[1] = bad[1].clone()
    bad[1][-1] -= 1
    with pytest.raises(ValueError, match='electrons: the edges end at'):
        s2.s2_photon_times(*bad, **kw)
    e_args, e_kw = electron_args(c)
    bad = list(e_args)
    bad[1] = bad[1].clone()
    bad[1][-1] += 2
    with pytest.raises(ValueError, match='electron draws: the edges end at'):
        s2.s2_electron_times(*bad, **e_kw)


def test_wrappers_raise_without_segments():
    """Elements without segments (no instruction, or photons without
    electrons) raise on the host before any launch: by the edges' check on
    the CPU (an empty edge array ends at 0), by the sizes on the card
    (tests/test_torch_cuda.py)."""
    c = case('empty instructions')
    g = list(gasgap_args(c))
    g[1:4] = (x[:0] for x in g[1:4])
    g[4] = g[4][:1]
    with pytest.raises(ValueError):
        s2.lumi_gasgap_times(*g, t_max=math.inf)
    args, kw = photon_args(c)
    bad = list(args)
    bad[2] = bad[2][:1]
    bad[3] = bad[3][:0]
    with pytest.raises(ValueError):
        s2.s2_photon_times(*bad, **kw)
    e_args, e_kw = electron_args(c)
    bad = [x[:0] if k in (0, 2, 3, 6) else x for k, x in enumerate(e_args)]
    bad[1] = e_args[1][:1]
    with pytest.raises(ValueError):
        s2.s2_electron_times(*bad, **e_kw)


# ---------------------------------------------------------------------------
# given-draw parity with wfsim_tpu on a skewed batch (JAX imported here)

#: photons an instruction of the skewed batch: one instruction of 10^6
SKEWED_COUNTS = (3000, 1_000_000, 2500, 0, 4000, 3100)


def test_gasgap_matches_jax_on_skewed_batch():
    """wfsim_tpu's ``luminescence_garfield_gasgap`` and the port's sampler
    from the same uniforms on instructions of 0 to 10^6 photons: the
    photons' T are the same float32 values (each 1-ns difference below is
    one that the means alone explain), and every time is within 1 ns.
    ROADMAP F12: wfsim_tpu sums an instruction's T in float32 (one
    scatter-add), the port exactly.  The 1-ns differences are exactly the
    photons whose truncation wfsim_tpu's float32 mean, rebuilt here by the
    same scatter-add of the same T, moves across an integer from the exact
    mean; on the instructions below 10^4 photons they are at most 1e-4 of
    the photons (F12), on the one of 10^6 its float32 sum moves ~0.2 %
    (measured 1,683 at this seed)."""
    import jax
    import jax.numpy as jnp
    from wfsim_tpu.config import default_config as jax_default_config
    from wfsim_tpu.models import s2 as js2
    from wfsim_tpu.models.params import (
        build_params as jax_build_params,
        build_constants as jax_build_constants)
    from wfsim_tpu.resources.loader import load_config as jax_load_config
    over = dict(s2_luminescence_model='garfield_gas_gap')
    cj = jax_default_config(**over)
    pj, kj = jax_build_params(cj, jax_load_config(cj)), \
        jax_build_constants(cj)
    c = default_config(**over)
    pt = build_params(c, load_config(c), 'cpu')
    counts = np.array(SKEWED_COUNTS)
    n_i, n = len(counts), int(counts.sum())
    xy = np.random.default_rng(5).uniform(-40, 40, (n_i, 2)).astype(
        np.float32)
    ph_inst = np.repeat(np.arange(n_i), counts)
    key = jax.random.key(31)
    d_j = np.asarray(js2.luminescence_garfield_gasgap(
        pj, kj, key, jnp.asarray(xy), jnp.asarray(ph_inst),
        jnp.ones(n, bool), n_i))
    u = np.asarray(jax.random.uniform(key, (n,)))
    edges = np.concatenate([[0], np.cumsum(counts)])
    rows = s2.gasgap_rows(pt, torch.from_numpy(xy))
    t = s2.lumi_gasgap_times(pt.gg_inv_cdf, *rows, torch.as_tensor(edges),
                             torch.from_numpy(u), t_max=pt.gg_t_max).numpy()
    T, x = gasgap_times_np(pt.gg_inv_cdf.numpy(), *(a.numpy() for a in rows),
                           ph_inst, u)
    exact = np.zeros(n_i, np.int64)
    np.add.at(exact, ph_inst, x.view(np.int64))
    m_t = means_np(exact, counts)
    m_j = np.asarray(jnp.zeros(n_i, jnp.float32).at[ph_inst].add(T)
                     / jnp.maximum(jnp.asarray(counts, jnp.float32), 1.0))
    lj = np.trunc(d_j).astype(np.int32)
    np.testing.assert_array_equal(lj, np.trunc(T - m_j[ph_inst]))
    np.testing.assert_array_equal(t, np.trunc(T - m_t[ph_inst]))
    assert np.all(np.abs(lj.astype(np.int64) - t) <= 1)
    diff = lj != t
    small = counts[ph_inst] < 10 ** 4
    assert diff[small].sum() <= 1e-4 * small.sum()
    assert 0 < diff[~small].sum() <= 5e-3 * (~small).sum()


def test_s2_photon_times_match_jax_on_skewed_batch():
    """The S2 pass of both packages from the same draws (as
    test_s2_pass_matches_jax_given_draws) on five instructions, one of
    ~10^6 photons: photon times within 1 ns in at most 1e-3 of the photons
    (the luminescence tables' float32 resample, PARITY.md), channels,
    truth and electron times as there."""
    from wfsim_tpu.config import default_config as jax_default_config
    from wfsim_tpu.models.params import (
        build_params as jax_build_params,
        build_constants as jax_build_constants)
    from wfsim_tpu.resources.loader import load_config as jax_load_config
    from .test_torch_photon_passes import check_s2_pass_given_draws
    cj, c = jax_default_config(), default_config()
    check_s2_pass_given_draws(
        ((jax_build_params(cj, jax_load_config(cj)),
          jax_build_constants(cj)),
         (c, build_params(c, load_config(c), 'cpu'), build_constants(c))),
        amps=(97_500, 300, 300, 300, 300))
