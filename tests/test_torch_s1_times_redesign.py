"""K9 S1, the S1 photon times (``csrc/photon_times.cu
wfsim_s1_photon_times``), on the CPU: a numpy emulation of the kernel's
decomposition against the twin ``s1_photon_times_ref``, the twin against
wfsim_tpu's time lines, and the wrapper's host checks.

The emulation follows the kernel, with the constants read from the
``.cu``: a block an instruction writes the instruction's first kS1Head
photons of its clamped edges, with no search; a tile of kS1Tile photons
[a, a + kS1Tile) over the batch finds the segment s of its first photon
(the count of clamped edges at or before a, minus one) and writes the
photons of s from offset kS1Head on that lie in the tile.  Every photon
below the last clamped edge must be written exactly once and none past
it.  Each photon's time is the kernel's float32 arithmetic in numpy:
``time[i] + trunc(exp * decay_time) + trunc(normal * decay_spread) +
trunc(custom) + trunc(nest)``, with the terms of the given inputs.
tests/test_torch_cuda.py holds the card's kernel to the twin on the same
cases.

wfsim_tpu's side is models/s1.py:143 ``simulate_s1``'s time lines
(168-188): its segment ids, ``time[ph_inst]``, the simple model's draws
from keys 3 and 4, ``_custom_recoil_delays`` from keys 5-15 and
``_nest_table_delays`` from key 16 on a small table, one jitted function
per model of one shape; the port's wrapper takes the same draws and
delays.

Tolerances: bitwise.
"""
import functools
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models import s1
from wfsim_tpu_torch.models.params import build_constants

SOURCE = (Path(__file__).resolve().parents[1] / 'wfsim_tpu_torch' / 'csrc'
          / 'photon_times.cu').read_text()


def cu_constant(name):
    return int(re.search(rf'constexpr (?:long long|int) {name} = (\d+);',
                         SOURCE).group(1))


HEAD = cu_constant('kS1Head')       # an instruction block's photons
TILE = cu_constant('kS1Tile')       # an overflow tile's photons
f32 = np.float32

#: the timing models' given inputs: the simple model's draws, the custom
#: and the NEST delays
MODELS = {'simple': ('simple',), 'custom': ('custom',), 'nest': ('nest',),
          'custom+nest': ('custom', 'nest'), '': ()}

#: name: the photon counts of a case ('sizes': instructions of 0, HEAD-1,
#: HEAD, HEAD+1, HEAD+TILE and 10^5 photons; 'many': 3,000 bench
#: instructions with runs of empty ones; 'tile edges': edges of empty
#: instructions on tile boundaries; 'skewed': chip_smoke.py's S1_SKEWED
#: batch, instruction 100 of 10^5 among bench S1s; 'empty': instructions
#: without photons)
CASES = ('bench', 'sizes', 'many', 'tile edges', 'skewed', 'empty')


def case_counts(name, rng):
    if name in ('bench', 'skewed'):
        counts = rng.poisson(13.5, 512)
        if name == 'skewed':
            counts[100] = 100_000
        return counts
    if name == 'sizes':
        return np.array([0, HEAD - 1, 0, HEAD, HEAD + 1, 0, 0, HEAD + TILE,
                         3, 100_000, 0, 5, 2 * HEAD + TILE + 7, 1])
    if name == 'many':
        counts = rng.poisson(13.5, 3000)
        counts[100:140] = 0
        counts[-9:] = 0
        return counts
    if name == 'tile edges':
        return np.array([TILE, 0, 0, TILE, 0, HEAD + TILE, 0, 0, TILE - 1,
                         1, 0, 3 * TILE, 0])
    return np.zeros(64, np.int64)


def s1_case(name, model, seed=7):
    """numpy (time, edges, truth_row, exp, nrm, nest, custom) of a case,
    the inputs of ``model`` given and the others None."""
    rng = np.random.default_rng(seed + len(name))
    counts = case_counts(name, rng)
    n_i, n = len(counts), int(counts.sum())
    time = rng.integers(0, 2 ** 30, n_i).astype(np.int32)
    row = np.sort(rng.integers(0, n_i // 2 + 1, n_i)).astype(np.int64)
    parts = MODELS[model]
    exp = nrm = nest = custom = None
    if 'simple' in parts:
        exp = rng.exponential(1.0, n).astype(f32)
        nrm = rng.normal(size=n).astype(f32)
    if 'custom' in parts:
        custom = rng.uniform(0, 1000.0, n).astype(f32)
    if 'nest' in parts:
        nest = rng.exponential(40.0, n).astype(f32)
    return (time, np.concatenate([[0], np.cumsum(counts)]), row, exp, nrm,
            nest, custom)


@functools.lru_cache(maxsize=1)
def const():
    return build_constants(default_config())


def emulate(time, edges, truth_row, exp, nrm, nest, custom, n,
            decay_time, decay_spread):
    """The kernel's blocks on n photons: (t, rows, writes a photon,
    instruction blocks that wrote, tiles that wrote)."""
    n_i = len(time)
    e = np.minimum(edges, n)
    t = np.zeros(n, np.int32)
    rows = np.full(n, -1, np.int64)
    writes = np.zeros(n, np.int64)
    dt, ds = f32(decay_time), f32(decay_spread)

    def write(js, i):
        tt = np.full(len(js), time[i], np.int32)
        if exp is not None:
            tt += np.trunc(exp[js] * dt).astype(np.int32)
            tt += np.trunc(nrm[js] * ds).astype(np.int32)
        if custom is not None:
            tt += np.trunc(custom[js]).astype(np.int32)
        if nest is not None:
            tt += np.trunc(nest[js]).astype(np.int32)
        t[js] = tt
        rows[js] = truth_row[i]
        writes[js] += 1

    blocks = tiles = 0
    for i in range(n_i):                       # the instruction blocks
        lo = e[i]
        hi = min(e[i + 1], lo + HEAD)
        if lo < hi:
            write(np.arange(lo, hi), i)
            blocks += 1
    for a in range(0, n, TILE):                # the overflow tiles
        s = int(np.searchsorted(e, a, side='right')) - 1
        if not 0 <= s < n_i:
            continue
        lo = max(a, e[s] + HEAD)
        hi = min(e[s + 1], a + TILE)
        if lo < hi:
            write(np.arange(lo, hi), s)
            tiles += 1
    return t, rows, writes, blocks, tiles


def twin(args, **kw):
    t, rows = s1.s1_photon_times_ref(
        *(None if a is None else torch.as_tensor(a) for a in args),
        decay_time=const().s1_decay_time,
        decay_spread=const().s1_decay_spread, **kw)
    return t.numpy(), rows.numpy()


@pytest.mark.parametrize('model', list(MODELS))
@pytest.mark.parametrize('name', CASES)
def test_s1_times_emulation_matches_twin(name, model):
    """Instruction blocks plus overflow tiles cover every photon once and
    give the twin's times and truth rows, for every model."""
    args = s1_case(name, model)
    edges = args[1]
    n = int(edges[-1])
    t, rows, writes, blocks, tiles = emulate(
        *args, n, const().s1_decay_time, const().s1_decay_spread)
    np.testing.assert_array_equal(writes, np.ones(n, np.int64))
    want_t, want_rows = twin(args)
    np.testing.assert_array_equal(t, want_t)
    np.testing.assert_array_equal(rows, want_rows)
    counts = np.diff(edges)
    assert blocks == int((counts > 0).sum())
    # a tile writes where it meets an instruction's photons past HEAD
    long_ = [(e0 + HEAD, e1) for e0, e1 in zip(edges[:-1], edges[1:])
             if e1 - e0 > HEAD]
    assert tiles == len({a for lo, hi in long_
                         for a in range(lo // TILE * TILE, hi, TILE)})
    if name in ('sizes', 'skewed'):
        assert tiles >= 100_000 // TILE - 1
    if name in ('bench', 'many', 'empty'):
        assert tiles == 0


@pytest.mark.parametrize('cut', [1, TILE + 3, 60_000])
def test_s1_times_emulation_clamps_edges(cut):
    """Edges past the photons: the kernel clamps them to n, so it writes
    the twin's photons of the clamped edges and none past n."""
    args = s1_case('sizes', 'simple')
    n = int(args[1][-1]) - cut
    clamped = np.minimum(args[1], n)
    short = (args[0], clamped, args[2], args[3][:n], args[4][:n], None,
             None)
    t, rows, writes, _b, _t = emulate(
        args[0], args[1], args[2], args[3][:n], args[4][:n], None, None, n,
        const().s1_decay_time, const().s1_decay_spread)
    np.testing.assert_array_equal(writes, np.ones(n, np.int64))
    want_t, want_rows = twin(short)
    np.testing.assert_array_equal(t, want_t)
    np.testing.assert_array_equal(rows, want_rows)


def test_s1_times_without_timing_model_take_the_total():
    """The '' model has no per-photon input: the wrapper takes the total
    from ``n_photons``, raises without it, and holds the CPU edges to it;
    where draws are given, ``n_photons`` must be their length."""
    time, edges, row, exp, nrm, _n, _c = (
        None if a is None else torch.as_tensor(a)
        for a in s1_case('bench', 'simple'))
    n = int(edges[-1])
    kw = dict(decay_time=const().s1_decay_time,
              decay_spread=const().s1_decay_spread)
    with pytest.raises(ValueError, match='n_photons'):
        s1.s1_photon_times(time, edges, row, None, None, **kw)
    with pytest.raises(ValueError, match='edges end'):
        s1.s1_photon_times(time, edges, row, None, None, n_photons=n - 1,
                           **kw)
    t, rows = s1.s1_photon_times(time, edges, row, None, None, n_photons=n,
                                 **kw)
    ph = np.repeat(np.arange(len(time)), np.diff(edges.numpy()))
    np.testing.assert_array_equal(t.numpy(), time.numpy()[ph])
    np.testing.assert_array_equal(rows.numpy(), row.numpy()[ph])
    with pytest.raises(ValueError, match='shape'):
        s1.s1_photon_times(time, edges, row, exp, nrm, n_photons=n + 1,
                           **kw)
    with pytest.raises(ValueError, match='edges end'):
        s1.s1_photon_times(time, edges, row, exp[:-1], nrm[:-1], **kw)
    with pytest.raises(ValueError, match='both'):
        s1.s1_photon_times(time, edges, row, exp, None, **kw)
    with pytest.raises(ValueError, match='edges end'):
        s1.s1_photon_times(time[:0], torch.zeros(1, dtype=torch.int64),
                           row[:0], None, None, n_photons=3, **kw)
    got = s1.s1_photon_times(time, edges, row, exp, nrm, n_photons=n, **kw)
    want = s1.s1_photon_times_ref(time, edges, row, exp, nrm, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the twin against wfsim_tpu's time lines


#: one shape for every model: instructions of 0, HEAD-1, HEAD, HEAD+1,
#: HEAD+TILE and 5,000 photons among bench S1s
JAX_COUNTS = np.array([13, 0, HEAD - 1, 20, HEAD, HEAD + 1, 0, 0, HEAD + TILE,
                       7, 5000, 11, 0, 2])


@pytest.fixture(scope='module')
def jax_time_lines():
    """{model: jitted f(time, counts, recoil, field, energy, key) ->
    (t, truth row index, exp, normal, custom, nest)}: simulate_s1's time
    lines with its keys, the delays of the models that are on (zeros
    else), compiled once per model for JAX_COUNTS' shape."""
    import jax
    import jax.numpy as jnp
    from wfsim_tpu.config import default_config as jax_default_config
    from wfsim_tpu.models import s1 as js1
    from wfsim_tpu.models.common import trunc_int
    from wfsim_tpu.models.params import build_constants as jax_constants
    from wfsim_tpu.ops.segment import segment_ids_from_counts
    kj = jax_constants(jax_default_config())
    rng = np.random.default_rng(11)
    params = SimpleNamespace(
        nest_inv_cdf=jnp.asarray(np.sort(rng.exponential(
            40.0, (4, 5, 6, 64)), axis=-1).astype(f32)),
        nest_fields=jnp.asarray(np.geomspace(10, 1000, 5).astype(f32)),
        nest_energies=jnp.asarray(np.geomspace(1, 300, 6).astype(f32)))
    n = int(JAX_COUNTS.sum())

    def make(parts):
        def f(time, counts, recoil, field, energy, key):
            keys = jax.random.split(key, js1.N_S1_KEYS)
            ph_inst, _valid, _total = segment_ids_from_counts(counts, n)
            t = time[ph_inst].astype(jnp.int32)
            zero = jnp.zeros(n, jnp.float32)
            exp = nrm = custom = nest = zero
            if 'simple' in parts:
                exp = jax.random.exponential(keys[3], (n,))
                nrm = jax.random.normal(keys[4], (n,))
                t = t + trunc_int(exp * kj.s1_decay_time)
                t = t + trunc_int(nrm * kj.s1_decay_spread)
            rc = js1._recoil_class(recoil)[ph_inst]
            if 'custom' in parts:
                custom = js1._custom_recoil_delays(kj, keys[5:16], rc, n)
                t = t + trunc_int(custom)
            if 'nest' in parts:
                nest = js1._nest_table_delays(params, keys[16], rc,
                                              field[ph_inst],
                                              energy[ph_inst], n)
                t = t + trunc_int(nest)
            return t, ph_inst, exp, nrm, custom, nest
        return jax.jit(f)
    return {m: make(parts) for m, parts in JAX_MODELS.items()}


#: every model of MODELS and the three together
JAX_MODELS = dict(MODELS, **{'simple+custom+nest': ('simple', 'custom',
                                                    'nest')})


@pytest.mark.parametrize('model', list(JAX_MODELS))
def test_s1_times_twin_matches_jax_time_lines(jax_time_lines, model):
    """The wrapper (its twin on the CPU) given simulate_s1's draws and
    delays gives its times bitwise, and each photon its instruction's
    truth row."""
    import jax
    rng = np.random.default_rng(13)
    n_i = len(JAX_COUNTS)
    time = (np.arange(n_i) * 40_000).astype(np.int32)
    recoil = np.resize(np.array([7, 0, 6, 20], np.int32), n_i)
    field = rng.uniform(5, 2000, n_i).astype(f32)
    energy = rng.uniform(0.5, 500, n_i).astype(f32)
    row = np.arange(n_i, dtype=np.int64) * 3
    t_j, ph_j, exp, nrm, custom, nest = (np.array(x) for x in
                                         jax_time_lines[model](
        time, JAX_COUNTS.astype(np.int32), recoil, field, energy,
        jax.random.key(17)))
    parts = JAX_MODELS[model]
    edges = np.concatenate([[0], np.cumsum(JAX_COUNTS)])
    if parts:
        assert np.any(t_j != time[ph_j])

    def given(part, x):
        return torch.as_tensor(x) if part in parts else None
    t, rows = s1.s1_photon_times(
        torch.as_tensor(time), torch.as_tensor(edges), torch.as_tensor(row),
        given('simple', exp), given('simple', nrm), given('nest', nest),
        given('custom', custom), decay_time=const().s1_decay_time,
        decay_spread=const().s1_decay_spread,
        n_photons=int(edges[-1]))
    np.testing.assert_array_equal(t.numpy(), t_j)
    np.testing.assert_array_equal(rows.numpy(), row[ph_j])
