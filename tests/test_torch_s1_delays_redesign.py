"""K13b and K15, the NEST and the custom S1 delays
(``csrc/table_samplers.cu wfsim_nest_delays`` and
``wfsim_s1_custom_delays``), on the CPU: a numpy emulation of the kernels'
decomposition against the unchanged twins ``nest_delays_ref`` and
``custom_delays_ref``, and the wrappers' host checks.

The emulation follows the kernels: tiles of 512 photons; a window of the
clamped edges staged a tile, every edge where the batch has fewer than
1,024 instructions (kDelayStage), else the edges of the tile's first to
last instruction (the warps' searches), at most 1,024 of them; what the
photons need of the window's instructions computed once a tile (NEST:
the four row offsets ((c F + fi) En + ei) M and the four weight products
wf[a] we[b]; custom: the class); each photon's instruction the last
window edge at or before it, from the staged edges (a warp's 128 photons
from the edges inside them, or by a search each past 31 such edges), or
from the global ones past them (a tile of hundreds of nearly empty
instructions), whose instructions are computed for each photon; the
NEST delay from the
four rows at the two quantiles around u (M-1), k1 clamped to M-1, summed
in the twin's order in float32; the custom delay from the draws of the
photon's class only (every other draw of the photon is NaN in the
emulation); photons outside the clamped edges not written.
tests/test_torch_cuda.py holds the card's kernels to the twins on the
same cases.  The twins' parity with wfsim_tpu is in
tests/test_torch_detector_physics.py and tests/test_torch_timing_models.py.

Tolerances: bitwise.
"""
import functools

import numpy as np
import pytest
import torch

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models import s1
from wfsim_tpu_torch.models.params import build_constants
from wfsim_tpu_torch.resources.nest_tables import (DEFAULT_ENERGIES,
                                                   DEFAULT_FIELDS)

TILE = 512
WARP = 128       # the photons of a warp, four a lane
STAGE = 1024
f32 = np.float32

#: name: photon counts of the instructions ('skewed': one alpha S1 of 10^5
#: photons at an energy past the grid among bench S1s; 'many': 4,096 bench
#: S1s, so the tiles' windows; 'tiny': 20,000 instructions of 0-3 photons,
#: tiles of hundreds of them, the first 8,000 of 0-1 photons, so more than
#: STAGE edges a tile; 'tile edges': instruction edges on tile edges)
S1_DELAY_CASES = ('bench', 'skewed', 'many', 'no instructions', 'empty',
                  'zeros', 'tiny', 'tile edges')


def delay_counts(name, rng):
    if name in ('bench', 'skewed', 'many'):
        counts = rng.poisson(13.5, 4096 if name == 'many' else 512)
        if name == 'skewed':
            counts[100] = 100_000
        return counts
    if name == 'no instructions':
        return np.zeros(0, np.int64)
    if name == 'empty':
        return np.zeros(64, np.int64)
    if name == 'zeros':
        counts = rng.poisson(13.5, 512) * (rng.random(512) < 0.5)
        counts[:5] = 0
        counts[-7:] = 0
        counts[60:90] = 0
        return counts
    if name == 'tiny':
        counts = rng.integers(0, 4, 20_000)
        counts[:8000] = rng.integers(0, 2, 8000)
        counts[5000] = 9000
        return counts
    return np.concatenate([np.full(8, 1024), [512, 512, 0, 2048, 1],
                           np.full(4, 1023)])


def special_uniforms(u):
    """0, 1 - 2^-24 and 1 (k1 clamped to M-1) among the uniforms."""
    u[::97] = 0.0
    u[1::97] = f32(1 - 2 ** -24)
    u[2::997] = 1.0
    return u


@functools.lru_cache(maxsize=1)
def nest_table():
    """A (4, 16, 16, 2048) float32 table of sorted delays (ns), the shape
    of build_nest_timing_tables'."""
    rng = np.random.default_rng(5)
    return np.sort(rng.exponential(40.0, (4, 16, 16, 2048)),
                   axis=-1).astype(np.float32)


def nest_case(name, seed=3):
    """numpy (table, cls, fi0, fi1, fw, ei0, ei1, ew, edges, u) of a case:
    random classes, fields and energies over and past both grid ends
    (the first eight instructions on and past each end)."""
    rng = np.random.default_rng(seed + len(name))
    counts = delay_counts(name, rng)
    n_i, n = len(counts), int(counts.sum())
    fields = np.asarray(DEFAULT_FIELDS, np.float32)
    energies = np.asarray(DEFAULT_ENERGIES, np.float32)
    fld = np.exp(rng.uniform(np.log(5), np.log(2000), n_i)).astype(np.float32)
    edep = np.exp(rng.uniform(np.log(0.1), np.log(1000), n_i)).astype(
        np.float32)
    ends = [(fields[0], energies[0]), (fields[-1], energies[-1]),
            (fields[0] / 2, energies[0] / 2), (fields[-1] * 2,
                                               energies[-1] * 2),
            (fields[0], energies[-1] * 3), (fields[-1], energies[0] / 3),
            (fields[0] / 3, energies[-1]), (fields[-1] * 3, energies[0])]
    for i, (f, e) in enumerate(ends[:n_i]):
        fld[i], edep[i] = f, e
    cls = rng.integers(0, 4, n_i)
    if name == 'skewed':
        cls[100] = 2                     # an alpha S1 at a few MeV
        edep[100] = 3000.0
    fi0, fi1, fw = (x.numpy() for x in s1.grid_pos(torch.as_tensor(fields),
                                                   torch.as_tensor(fld)))
    ei0, ei1, ew = (x.numpy() for x in s1.grid_pos(
        torch.as_tensor(energies), torch.as_tensor(edep)))
    u = special_uniforms(rng.random(n, dtype=np.float32))
    return (nest_table(), cls, fi0, fi1, fw, ei0, ei1, ew,
            np.concatenate([[0], np.cumsum(counts)]), u)


def custom_case(name, seed=5):
    """numpy (cls, edges, draws) of a case: the classes cycling ER, NR,
    alpha, LED (the skewed instruction alpha), recombination uniforms of
    1e-12 (clamped from 0, as wfsim_tpu draws them) among the draws."""
    rng = np.random.default_rng(seed + len(name))
    counts = delay_counts(name, rng)
    n_i, n = len(counts), int(counts.sum())
    cls = np.resize(np.arange(4), n_i)
    rng.shuffle(cls)
    if name == 'skewed':
        cls[100] = 2
    draws = {k: (rng.exponential(1.0, n).astype(np.float32)
                 if k.startswith('exp') else
                 special_uniforms(rng.random(n, dtype=np.float32)))
             for k in s1.CUSTOM_DRAWS}
    draws['u_reco'] = s1.reco_uniform(torch.as_tensor(
        draws['u_reco'])).numpy()
    return cls, np.concatenate([[0], np.cumsum(counts)]), draws


def tiles_of(edges, n, S, stats):
    """Per tile (a, b, w0, staged, seg, ok), as the kernels find them: the
    window of clamped edges e(w0) .. e(w0 + cnt - 1) (every edge where S <
    STAGE, else the tile's first to last instruction), min(cnt, STAGE) of
    them staged, each photon's instruction seg (the last window edge at or
    before it: among the staged edges, else among the global ones) and
    whether it is one (ok)."""
    e = np.minimum(edges, n)
    for a in range(0, n, TILE):
        b = min(a + TILE, n)
        if S < STAGE:
            w0, cnt = 0, S + 1
        else:
            s0 = int(np.searchsorted(e, a, side='right')) - 1
            s1_ = int(np.searchsorted(e, b - 1, side='right')) - 1
            if s0 == s1_ and not 0 <= s0 < S:
                continue
            w0 = max(s0, 0)
            cnt = s1_ - w0 + 1
        staged = min(cnt, STAGE)
        stats['tiles'] += 1
        stats['windows'] += S >= STAGE
        for wa in range(a, b, WARP):     # a warp's photons, past 31 edges
            inside = (e[w0:w0 + staged] > wa) & (e[w0:w0 + staged] < wa + WARP)
            stats['warp_searches'] += int(inside.sum()) >= 32
        j = np.arange(a, b)
        k = np.searchsorted(e[w0:w0 + staged], j, side='right') - 1
        seg = w0 + k
        beyond = (k == staged - 1) & (staged < cnt)
        if beyond.any():
            stats['overflow'] += 1
            seg[beyond] = w0 + np.searchsorted(e[w0:w0 + cnt], j[beyond],
                                               side='right') - 1
        yield a, b, w0, staged, seg, (seg >= 0) & (seg < S)


def per_instruction(make, w0, staged, seg, ok, S, stats):
    """What each photon takes from its instruction: make() of the window's
    staged instructions w0 + k, k < staged, once, indexed by seg - w0, and
    make() of an instruction past them for its photons."""
    ss = w0 + np.arange(staged)
    inr = ss < S
    stats['staged'] += int(inr.sum())
    idx = np.clip(seg - w0, 0, staged - 1)
    once = []
    for x in make(ss[inr]):
        full = np.zeros((staged,) + x.shape[1:], x.dtype)
        full[inr] = x
        once.append(full[idx])
    past = ok & (seg - w0 >= staged)
    if past.any():
        stats['past'] += len(np.unique(seg[past]))
        for o, x in zip(once, make(seg[past])):
            o[past] = x
    return once


def nest_rows_np(table, cls, fi0, fi1, fw, ei0, ei1, ew, ss):
    """The rows (k, 4) int64 and weight products (k, 4) float32 of
    instructions ss, in the twin's corner order."""
    _, F, En, M = table.shape
    wf = (f32(1) - fw[ss], fw[ss])
    we = (f32(1) - ew[ss], ew[ss])
    f, e = (fi0[ss], fi1[ss]), (ei0[ss], ei1[ss])
    rows = np.stack([((cls[ss] * F + f[p]) * En + e[q]) * M
                     for p in range(2) for q in range(2)], 1)
    w = np.stack([wf[p] * we[q] for p in range(2) for q in range(2)], 1)
    return rows, w.astype(np.float32)


def emulate_nest(table, cls, fi0, fi1, fw, ei0, ei1, ew, edges, u):
    """(out, stats) as the kernel computes them; out is NaN where nothing
    was written; stats: see new_stats."""
    n, S, M = len(u), len(cls), table.shape[-1]
    flat = table.reshape(-1)
    out = np.full(n, np.nan, np.float32)
    stats = new_stats()
    scale = f32(M - 1)
    for a, b, w0, staged, seg, ok in tiles_of(edges, n, S, stats):
        rows, w = per_instruction(
            lambda ss: nest_rows_np(table, cls, fi0, fi1, fw, ei0, ei1, ew,
                                    ss), w0, staged, seg, ok, S, stats)
        s = u[a:b] * scale
        k0 = np.floor(s).astype(np.int64)
        k1 = np.minimum(k0 + 1, M - 1)
        kw = s - k0.astype(np.float32)
        omk = f32(1) - kw
        acc = np.zeros(b - a, np.float32)
        for c in range(4):
            lo = flat[np.where(ok, rows[:, c] + k0, 0)]
            hi = flat[np.where(ok, rows[:, c] + k1, 0)]
            acc = acc + w[:, c] * (lo * omk + hi * kw)
        out[a:b][ok] = acc[ok]
    return out, stats


#: the draws each class reads (ER, or any other class, the primary uniform,
#: both pairs and the recombination uniform)
CLASS_DRAWS = {1: ('u_nr', 'exp_nr'), 2: ('u_alpha', 'exp_alpha'),
               3: ('u_led',), 0: ('u_prim', 'u_st_prim', 'exp_st_prim',
                                  'u_reco', 'u_st_sec', 'exp_st_sec')}


def emulate_custom(cls, edges, draws, const):
    """(out, stats) as the kernel computes them (see emulate_nest), each
    photon reading the draws of its class only (the others NaN)."""
    n, S = len(draws['u_prim']), len(cls)
    t1, t3 = f32(const.singlet_lifetime_liquid), f32(
        const.triplet_lifetime_liquid)
    out = np.full(n, np.nan, np.float32)
    stats = new_stats()

    def st(u, e, frac):
        life = np.where(u < f32(frac), t1, t3)
        return np.trunc(e * life).astype(np.int32).astype(np.float32)
    for a, b, w0, staged, seg, ok in tiles_of(edges, n, S, stats):
        (c,) = per_instruction(lambda ss: (cls[ss],), w0, staged, seg, ok, S,
                               stats)
        er = ~np.isin(c, (1, 2, 3))
        x = {k: np.full(b - a, np.nan, np.float32) for k in draws}
        for k_cls, keys in CLASS_DRAWS.items():
            sel = ok & (er if k_cls == 0 else c == k_cls)
            for k in keys:
                x[k][sel] = draws[k][a:b][sel]
        with np.errstate(invalid='ignore', divide='ignore'):
            u = np.maximum(x['u_reco'], f32(1e-12))
            reco = f32(const.er_recombination_time) * (f32(-1) + f32(1) / u)
            reco = np.clip(reco, f32(0), f32(1000))
            v = np.where(
                x['u_prim'] < f32(const.er_primary_excimer_fraction),
                st(x['u_st_prim'], x['exp_st_prim'],
                   const.s1_ER_primary_singlet_fraction),
                reco + st(x['u_st_sec'], x['exp_st_sec'],
                          const.s1_ER_secondary_singlet_fraction))
            v = np.where(c == 1, st(x['u_nr'], x['exp_nr'],
                                    const.s1_NR_singlet_fraction), v)
            v = np.where(c == 2, st(x['u_alpha'], x['exp_alpha'],
                                    const.s1_ER_alpha_singlet_fraction), v)
            v = np.where(c == 3, x['u_led'] * f32(const.led_pulse_length), v)
        out[a:b][ok] = v[ok]
    return out, stats


@functools.lru_cache(maxsize=1)
def custom_const():
    return build_constants(default_config(s1_model_type='custom'))


def new_stats():
    """tiles; tiles with a window of their own (S >= STAGE); tiles with
    more than STAGE edges; warps with more than 31 staged edges inside
    their photons (a search a photon); staged instructions; instructions
    past the staged ones (counted once a tile)."""
    return dict(tiles=0, windows=0, overflow=0, warp_searches=0, staged=0,
                past=0)


def check_stats(name, stats, n):
    assert stats['tiles'] == -(-n // TILE)
    if name in ('many', 'tiny'):
        assert stats['windows'] == stats['tiles']
    else:
        assert stats['windows'] == 0
    if name == 'tiny':               # more than STAGE edges a tile
        assert 0 < stats['overflow'] < stats['tiles']
        assert stats['past'] > 0 and stats['warp_searches'] > 0
    else:
        assert stats['overflow'] == stats['past'] == 0
    if name in ('bench', 'skewed', 'many'):   # a few edges a warp
        assert stats['warp_searches'] == 0
    if name in ('tiny', 'zeros'):             # runs of empty instructions
        assert stats['warp_searches'] > 0


@pytest.mark.parametrize('name', S1_DELAY_CASES)
def test_nest_emulation_matches_twin(name):
    """Windows, staged rows and weight products: the bench batch, one
    alpha instruction of 10^5 photons past the energy grid, 4,096 bench
    instructions, no instructions, only empty ones, runs of empty ones,
    tiles of hundreds of instructions, edges on tile edges; u of 0,
    1 - 2^-24 and 1; fields and energies on and past both grid ends."""
    case = nest_case(name)
    want = s1.nest_delays_ref(*(torch.as_tensor(a) for a in case)).numpy()
    got, stats = emulate_nest(*case)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    check_stats(name, stats, len(got))


@pytest.mark.parametrize('name', S1_DELAY_CASES)
def test_custom_emulation_matches_twin(name):
    """The same cases for the custom delays: every class, each photon
    reading only its class's draws, recombination uniforms clamped."""
    cls, edges, draws = custom_case(name)
    const = custom_const()
    want = s1.custom_delays_ref(
        torch.as_tensor(cls), torch.as_tensor(edges),
        {k: torch.as_tensor(v) for k, v in draws.items()},
        const=const).numpy()
    got, stats = emulate_custom(cls, edges, draws, const)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    check_stats(name, stats, len(got))


def test_nest_wrapper_checks_on_cpu():
    """The host checks: uniforms that the edges do not end at, inputs of
    the wrong dtype or length, a table that is not 4-d; then the twin."""
    args = [torch.as_tensor(a) for a in nest_case('zeros')]
    with pytest.raises(ValueError, match='edges end'):
        s1.nest_delays(*args[:9], args[9][:-1])
    with pytest.raises(ValueError, match='edges end'):
        s1.nest_delays(args[0], *(a[:0] for a in args[1:8]),
                       torch.zeros(1, dtype=torch.int64), args[9])
    with pytest.raises(TypeError, match='fw'):
        s1.nest_delays(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError, match='shape'):
        s1.nest_delays(args[0], args[1][:-1], *args[2:])
    with pytest.raises(ValueError, match='table'):
        s1.nest_delays(args[0][0], *args[1:])
    assert torch.equal(s1.nest_delays(*args), s1.nest_delays_ref(*args))


def test_custom_wrapper_checks_on_cpu():
    """The host checks: draws that the edges do not end at, draws of
    different lengths, a missing draw, classes of the wrong dtype; then
    the twin."""
    cls, edges, draws = custom_case('zeros')
    cls, edges = torch.as_tensor(cls), torch.as_tensor(edges)
    d = {k: torch.as_tensor(v) for k, v in draws.items()}
    const = custom_const()
    short = {k: v[:-1] for k, v in d.items()}
    with pytest.raises(ValueError, match='edges end'):
        s1.custom_delays(cls, edges, short, const=const)
    with pytest.raises(ValueError, match='shape'):
        s1.custom_delays(cls, edges, dict(d, u_led=d['u_led'][:-1]),
                         const=const)
    with pytest.raises(ValueError, match='custom draws'):
        s1.custom_delays(cls, edges, {k: d[k] for k in list(d)[1:]},
                         const=const)
    with pytest.raises(TypeError, match='cls'):
        s1.custom_delays(cls.int(), edges, d, const=const)
    with pytest.raises(ValueError, match='edges end'):
        s1.custom_delays(cls[:0], torch.zeros(1, dtype=torch.int64), d,
                         const=const)
    assert torch.equal(s1.custom_delays(cls, edges, d, const=const),
                       s1.custom_delays_ref(cls, edges, d, const=const))
