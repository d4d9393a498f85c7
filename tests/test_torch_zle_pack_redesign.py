"""The ZLE interval search and the record pack of wfsim_tpu_torch
(``zle_all_channels`` and ``pack_records``; on the CPU their plain twins)
against wfsim_tpu's ``zle_all_channels`` and ``pack_records``, and the
intervals against the sequential oracle ``intervals_below_threshold``, on
the cases to which the kernels of ``csrc/zle_intervals.cu`` (a warp a row,
1,024 samples a step, 32 a lane; at most one start a lane when holdoff >=
31, else a walk of the lane's below samples) and ``csrc/pack_records.cu``
(a plan by row, a warp copying a row's records as int16 pairs, aligned
4-byte loads inside the row) are sensitive.  tests/test_torch_cuda.py holds the
kernels bitwise against the twins on the same cases.

The cases are numpy only, made from a seed (``zle_pack_case``), so that
the card's machine, which has no JAX, can import them: JAX is imported
inside the fixture that uses it.

Tolerance: bitwise — starts, ends (every slot, sentinels included),
counts, record payloads and meta.
"""
import numpy as np
import pytest
import torch

from wfsim_tpu_torch.ops.zle import zle_all_channels
from wfsim_tpu_torch.pipeline.digitize import pack_records

from .reference_semantics import intervals_below_threshold

BASE, THR = 16000, 15984
#: wfsim_tpu's pack_records output rows (a static size: one compile a shape)
MAX_RECORDS = 2048

ZLE_PACK_CASES = (
    'gaps of holdoff and holdoff + 1 across a step',
    'holdoff 1',
    'holdoff 30',
    'holdoff 31',
    'holdoff 300',
    'holdoff 1100, more than a step',
    'a run that reaches ch_right',
    'a whole window below threshold',
    'alternating samples',
    'more than K intervals',
    'T = 8195, unaligned windows',
    'nonneg with negative int16 samples',
    'has false over below samples',
    'intervals of 110, 111 and 220 samples',
    'records that clip at T - 1',
    'a batch with no records',
)


def zle_pack_case(name):
    """One case as a dict: ``data`` (B, C, T) int16, ``grid`` the int32
    values wfsim_tpu's ZLE compares (the int16 samples, or on the full
    grid, ``nonneg``, the values before the int16 cast), ``thr`` (B*C,)
    int32, ``left``/``right`` (B, C) int32, ``has`` (B, C) bool,
    ``holdoff``, ``tw``, ``K``, ``nonneg`` and ``intervals``: None (the
    pack takes the ZLE's output) or explicit (starts, ends, counts) for the
    pack."""
    rng = np.random.default_rng(ZLE_PACK_CASES.index(name) + 1100)
    B, C, T, holdoff, tw, K = 2, 8, 2048, 101, 50, 8
    if name in ('T = 8195, unaligned windows',
                'holdoff 1100, more than a step'):
        T = 8195
    grid = (BASE + rng.integers(-3, 4, (B, C, T))).astype(np.int32)
    left = rng.integers(0, 300, (B, C)).astype(np.int32)
    right = rng.integers(T - 300, T, (B, C)).astype(np.int32)
    has = np.ones((B, C), bool)
    thr = np.full(B * C, THR, np.int32)
    rows = [(w, c) for w in range(B) for c in range(C)]
    nonneg = False
    intervals = None

    def below(w, c, a, b):
        """Samples a..b (inclusive, clipped to the grid) below threshold."""
        a, b = max(a, 0), min(b, T - 1)
        if b >= a:
            grid[w, c, a:b + 1] = THR - rng.integers(1, 400, b - a + 1)

    if name == 'gaps of holdoff and holdoff + 1 across a step':
        # pairs of runs whose gap (distance of the two below samples) is
        # holdoff (one interval) or holdoff + 1 (two), with the first run's
        # end a few samples before or after a lane's 32 samples end, and
        # the 1,024-sample step's
        for i, (w, c) in enumerate(rows):
            left[w, c] = 8 * i + (i % 3)
            right[w, c] = T - 1 - (i % 5)
            base = left[w, c] - (left[w, c] % 8)
            for m, step in enumerate((256, 1024, 1504)):
                e = base + step - 4 + (i + m) % 9
                below(w, c, e - 5, e)
                gap = holdoff + (i + m) % 2
                below(w, c, e + gap, e + gap + 3)
    elif name.startswith('holdoff'):
        # a lane holds several starts below holdoff 31, one from 31 on
        holdoff = int(name.split()[1].rstrip(','))
        tw = max((holdoff - 1) // 2, 0)
        K = 64 if holdoff <= 31 else 8
        for w, c in rows:
            x = int(left[w, c]) + int(rng.integers(0, 20))
            while x < right[w, c]:
                run = int(rng.integers(1, 12))
                below(w, c, x, x + run - 1)
                # gaps under, at and over the holdoff, and over a step
                x += run - 1 + int(rng.choice(
                    [holdoff, holdoff + 1, holdoff + 2, max(holdoff - 1, 1),
                     300, 1100]))
    elif name == 'a run that reaches ch_right':
        for i, (w, c) in enumerate(rows):
            r = int(right[w, c])
            below(w, c, r - 30 - i, r - (i % 3 == 1))
            below(w, c, r + 1, r + 20)      # outside the window: ignored
            below(w, c, int(left[w, c]), int(left[w, c]) + i)
            below(w, c, int(left[w, c]) - 20, int(left[w, c]) - 1)
    elif name == 'a whole window below threshold':
        for i, (w, c) in enumerate(rows):
            if i % 2 == 0:
                left[w, c], right[w, c] = (0, T - 1) if i % 4 == 0 else (
                    left[w, c], right[w, c])
                below(w, c, 0, T - 1)
            else:
                below(w, c, int(left[w, c]), int(right[w, c]))
    elif name == 'alternating samples':
        holdoff, tw, K = 1, 0, 64
        for i, (w, c) in enumerate(rows):
            a = int(left[w, c]) + 3 * i
            n = 40 if i % 2 else 600    # fewer than K starts, or 300
            for x in range(a, a + n, 2):
                below(w, c, x, x)
    elif name == 'more than K intervals':
        for i, (w, c) in enumerate(rows):
            n = (K - 1, K, K + 1, K + 2, 3 * K)[i % 5]
            x = int(left[w, c]) + i
            for _ in range(n):
                below(w, c, x, x + int(rng.integers(0, 30)))
                x += 30 + holdoff + 1 + int(rng.integers(0, 10))
            right[w, c] = max(int(right[w, c]), min(x, T - 1))
    elif name == 'T = 8195, unaligned windows':
        left[:, 0], right[:, 0] = 0, T - 1
        left[:, 1:] = rng.integers(1, 600, (B, C - 1)) * 2 + 1
        for w, c in rows:
            for _ in range(int(rng.integers(5, 20))):
                x = int(rng.integers(0, T))
                below(w, c, x, x + int(rng.integers(0, 40)))
            below(w, c, int(right[w, c]) - 3, int(right[w, c]) + 3)
            below(w, c, int(left[w, c]) - 3, int(left[w, c]) + 3)
        K = 64
    elif name == 'nonneg with negative int16 samples':
        # the full grid before its int16 cast: in-window values in
        # [0, 2^16); those >= 2^15 wrap to negative int16 samples, which
        # are never below threshold
        nonneg = True
        for i, (w, c) in enumerate(rows):
            for _ in range(6):
                x = int(rng.integers(left[w, c], right[w, c] - 40))
                grid[w, c, x:x + 8] = rng.integers(2 ** 15, 2 ** 16, 8)
                gap = (i % 2) * holdoff
                below(w, c, x + 8 + gap, x + 20 + gap)
                grid[w, c, x + 21:x + 24] = rng.integers(0, 5, 3)
        thr[1::3] = THR + 3000
    elif name == 'has false over below samples':
        has[:, 1::2] = False
        for w, c in rows:
            for x in rng.integers(left[w, c], right[w, c] - 50, 5):
                below(w, c, int(x), int(x) + 30)
    elif name in ('intervals of 110, 111 and 220 samples',
                  'records that clip at T - 1'):
        for w, c in rows:
            x = int(rng.integers(left[w, c], right[w, c] - 400))
            below(w, c, x, x + int(rng.integers(0, 250)))
        starts = np.zeros((B, C, K), np.int32)
        ends = np.zeros((B, C, K), np.int32)
        counts = np.zeros((B, C), np.int32)
        if name == 'intervals of 110, 111 and 220 samples':
            lens = (110, 111, 220, 221, 109, 1, 330, 0, -1)
        else:
            lens = (110, 111, 220, 400, 333, 7)
        for i, (w, c) in enumerate(rows):
            n = i % (K + 1)
            x = int(rng.integers(0, 40))
            for k in range(n):
                plen = lens[(i + k) % len(lens)]
                starts[w, c, k], ends[w, c, k] = x, x + plen - 1
                x += max(plen, 0) + int(rng.integers(0, 40))
            counts[w, c] = n
            if name == 'records that clip at T - 1':
                # the last interval runs past sample T - 1 of the grid; one
                # row starts before sample 0
                lo = int(left[w, c])
                starts[w, c, max(n - 1, 0)] = T - 150 - lo + i
                ends[w, c, max(n - 1, 0)] = T + 300 - lo
                counts[w, c] = max(n, 1)
        if name == 'records that clip at T - 1':
            starts[0, 0, 0] = -int(left[0, 0]) - 37
        counts[1, 2] = K + 3              # a count past K: all K slots
        counts[1, 3] = -2                 # a negative count: none
        intervals = (starts, ends, counts)
    elif name == 'a batch with no records':
        has[0, :4] = False
        for w, c in rows[:4]:
            below(w, c, 500, 700)         # under has false
    else:
        raise KeyError(name)
    data = grid.astype(np.int16)          # wraps values >= 2^15 (nonneg)
    return dict(data=data, grid=grid, thr=thr, left=left, right=right,
                has=has, holdoff=holdoff, tw=tw, K=K, nonneg=nonneg,
                intervals=intervals)


def zle_args(case, dev='cpu'):
    """(args, kw) of ``zle_all_channels`` for a case, on ``dev``."""
    B, C, T = case['data'].shape
    args = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (case['data'].reshape(B * C, T), case['thr'],
                           case['left'].reshape(-1),
                           case['right'].reshape(-1),
                           case['has'].reshape(-1)))
    kw = dict(holdoff=case['holdoff'], trigger_window=case['tw'],
              max_intervals=case['K'], nonneg=case['nonneg'])
    return args, kw


def pack_args(case, zle_out, dev='cpu'):
    """The arguments of ``pack_records`` for a case: its explicit
    intervals, or ``zle_out`` (starts, ends, counts of the ZLE)."""
    B, C, T = case['data'].shape
    K = case['K']
    starts, ends, counts = (case['intervals'] if case['intervals'] is not None
                            else [np.asarray(x.cpu()) for x in zle_out])
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (case['data'], case['left'],
                           starts.reshape(B, C, K), ends.reshape(B, C, K),
                           counts.reshape(B, C)))


def oracle(case):
    """The sequential reference's intervals of every row, padded, clipped,
    landed on even offsets, the first K (as in tests/test_torch_zle.py)."""
    B, C, T = case['data'].shape
    out = []
    for r in range(B * C):
        w, c = divmod(r, C)
        if not case['has'][w, c]:
            out.append([])
            continue
        lo, hi = int(case['left'][w, c]), int(case['right'][w, c])
        seg = case['grid'][w, c, lo:hi + 1].astype(np.int64)
        itv = intervals_below_threshold(seg, int(case['thr'][r]),
                                        case['holdoff'])
        n, tw = len(seg), case['tw']
        out.append([(((min(max(a - tw, 0), n - 1) + 1) // 2) * 2,
                     (min(max(b + tw, 0), n - 1) // 2) * 2)
                    for a, b in itv[:case['K']]])
    return out


@pytest.fixture(scope='module')
def jax_ops():
    """wfsim_tpu's zle_all_channels and pack_records (JAX on the CPU)."""
    import jax.numpy as jnp
    from wfsim_tpu.ops.zle import zle_all_channels as jzle
    from wfsim_tpu.pipeline.digitize import pack_records as jpack
    return jnp, jzle, jpack


@pytest.mark.parametrize('name', ZLE_PACK_CASES)
def test_zle_matches_jax_and_oracle(jax_ops, name):
    jnp, jzle, _ = jax_ops
    case = zle_pack_case(name)
    B, C, T = case['data'].shape
    args, kw = zle_args(case)
    ts, te, tc = zle_all_channels(*args, **kw)
    js, je, jc = jzle(jnp.asarray(case['grid'].reshape(B * C, T)),
                      *(jnp.asarray(a.numpy()) for a in args[1:]),
                      holdoff=kw['holdoff'],
                      trigger_window=kw['trigger_window'],
                      max_intervals=kw['max_intervals'])
    for what, a, b in (('starts', js, ts), ('ends', je, te),
                       ('counts', jc, tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)
    ref = oracle(case)
    for r in range(B * C):
        n = int(tc[r])
        assert list(zip(ts[r, :n].tolist(), te[r, :n].tolist())) == ref[r], r
    if name == 'a batch with no records':
        assert int(tc.sum()) == 0
    else:
        assert int(tc.sum()) > 0
    if name in ('more than K intervals', 'alternating samples'):
        assert int((tc == case['K']).sum()) > 0    # rows past the K slots


@pytest.mark.parametrize('name', ZLE_PACK_CASES)
def test_pack_matches_jax(jax_ops, name):
    jnp, _, jpack = jax_ops
    case = zle_pack_case(name)
    B, C, T = case['data'].shape
    K = case['K']
    args, kw = zle_args(case)
    pargs = pack_args(case, zle_all_channels(*args, **kw))
    rd, rm = pack_records(*pargs)
    n_rec = rd.shape[0]
    _data, left, starts, ends, counts = (a.numpy() for a in pargs)
    valid = np.arange(K)[None, None, :] < counts[:, :, None]
    assert n_rec <= MAX_RECORDS
    pk = jpack(jnp.asarray(case['grid']), jnp.asarray(left),
               jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(valid),
               n_channels_total=C, n_samples=T, max_intervals=K,
               max_records=MAX_RECORDS)
    np.testing.assert_array_equal(np.asarray(pk['rec_data'])[:n_rec],
                                  rd.numpy())
    np.testing.assert_array_equal(np.asarray(pk['rec_meta'])[:n_rec],
                                  rm.numpy())
    if name == 'a batch with no records':
        assert n_rec == 0
    else:
        assert n_rec > B * C // 2
    if name == 'records that clip at T - 1':
        assert int((rm[:, 2] + rm[:, 3] > T).sum()) > 0   # past T - 1
