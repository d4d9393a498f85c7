"""The order of a digitize round's records (``pipeline.digitize.round_order``,
kernel ``csrc/round_order.cu``) on the CPU: the fact its design rests on,
and a numpy emulation of the kernel against its plain version.

wfsim_tpu sorts a round's records with ``np.lexsort((C, S, W))``
(pipeline/rawdata.py:1780); the port's plain version, ``round_order_ref``,
with one stable sort of packed (window, start, channel) keys.  The kernel
instead takes each window's records where K4 (``pack_records``) wrote
them: one run a window (a window lies in one batch, written window by
window), in (channel, start) order.

Tolerances, per quantity (all exact):

- on randomized K4 outputs (``order_case``: several batches taking the
  round's windows in shuffled order, empty windows, a window of 10^4
  records, the full grid's HE channels 500-752 on 801 rows, starts shared
  by many channels) and on ``pack_records_ref``'s outputs
  (tests/test_torch_record_arena.py's ``row_case``): a stable sort by
  start within each window, in K4's source order, gives wfsim_tpu's
  lexsort order and ``round_order_ref``'s permutation;
- the emulation (each batch window's first record by the warp's 32-probe
  search, the counts and bases by the last block's scan, each window
  ranked by counting its starts in 4,096 bins, shifted right as far as
  its largest start needs, the ties of a bin filled in a shuffled order
  and ranked by (start, channel); a window past the kernel's chunk of
  4,096 records cut into chunks, each taken by the block the grid's
  mapping gives it, ranked so, and each of the window's other records
  counted at its place among the chunk's words) against
  ``round_order_ref``: ``perm``, ``win`` and ``counts`` equal, each chunk
  taken by exactly one block of a grid of a block a window plus one for
  each chunk's worth of the round's records, also with 16 bins (shifted
  starts in most windows) and under a chunk of 64 that cuts windows into
  many chunks;
- the warp search against ``np.searchsorted`` on runs with repeats and
  values past both ends.

The cases are numpy only, made from a seed, so that
tests/test_torch_cuda.py can import them on the card's machine.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from wfsim_tpu_torch.pipeline import digitize as dg
from wfsim_tpu_torch.pipeline.digitize import round_order, round_order_ref

from .test_torch_record_arena import DT, ROW_CASES, lexsort_records, row_case

ORDER_CASES = ('several batches', 'long window', 'he channels', 'ties')
#: HE channels of the XENONnT full grid (n_channels_total 801)
HE_CHANNELS = (500, 753)
#: the kernel's constants (csrc/round_order.cu)
CAP = 4096
BINS = 4096
SORT_THREADS = 512


def order_case(name):
    """One case of ``round_order``'s inputs, numpy only: ``parts`` (per
    batch: its windows' round indices, rec_data (n, 110) int16 and
    rec_meta (n, 6) int32 as K4 writes them: window by window, channel by
    channel, starts increasing and unique within a channel), ``win_left``,
    ``n_samples`` and ``n_rows``.

    - several batches: 30 windows in four batches, five windows empty;
    - long window: as above, and one window of 10,240 records (64
      channels of 160);
    - he channels: 801 rows, channels 0-493 and 500-752;
    - ties: every start one of eight, so most starts are shared by many
      channels.
    """
    rng = np.random.default_rng(ORDER_CASES.index(name) + 3100)
    n_rows, T, n_win = 64, 4096, 30
    chans = np.arange(n_rows)
    if name == 'he channels':
        n_rows = 801
        chans = np.concatenate([np.arange(494), np.arange(*HE_CHANNELS)])
    if name == 'long window':
        T = 2 ** 14
    order = rng.permutation(n_win)
    batches = [np.sort(b) for b in np.split(order, [7, 8, 19])]
    empty = set(rng.choice(n_win, 5, replace=False).tolist())
    long_w = int(order[3]) if name == 'long window' else -1
    empty.discard(long_w)
    parts = []
    for batch in batches:
        rows = []
        for bi, w in enumerate(batch):
            if int(w) in empty:
                continue
            if int(w) == long_w:
                pick, per = np.arange(64), 160
            else:
                pick = np.sort(rng.choice(chans, int(rng.integers(
                    1, min(len(chans), 40))), replace=False))
                per = None
            for c in pick:
                k = per or int(rng.integers(1, 6))
                if name == 'ties':
                    starts = np.sort(rng.choice(8, min(k, 8), replace=False)
                                     ) * 110
                else:
                    starts = np.sort(rng.choice(T, k, replace=False))
                for s in starts:
                    rows.append((bi, c, s, rng.integers(1, 111),
                                 rng.integers(1, 900), rng.integers(0, 9)))
        meta = np.asarray(rows, np.int32).reshape(-1, 6)
        data = rng.integers(-2 ** 15, 2 ** 15,
                            (len(meta), 110)).astype(np.int16)
        parts.append((batch, data, meta))
    win_left = (10 ** 11 + np.cumsum(rng.integers(T, 50 * T, n_win))
                ).astype(np.int64)
    return dict(parts=parts, win_left=win_left, n_samples=T, n_rows=n_rows)


def long_round_case(n_long=100_000):
    """Three windows in two batches, window 1 of ``n_long`` records or a
    few more (494 channels, starts unique within a channel, T 2^17),
    windows 0 and 2 of a few hundred: the card's test of a long window."""
    rng = np.random.default_rng(n_long)
    T, C = 2 ** 17, 494
    per = -(-n_long // C)
    rows = {0: [], 1: [], 2: []}
    for w, k in ((0, 3), (1, per), (2, 2)):
        for c in range(C if w == 1 else 100):
            for s in np.sort(rng.choice(T, k, replace=False)):
                rows[w].append((c, s, rng.integers(1, 111),
                                rng.integers(1, 900), rng.integers(0, 9)))
    parts = []
    for batch in (np.array([0, 2]), np.array([1])):
        meta = np.asarray([(bi, *r) for bi, w in enumerate(batch)
                           for r in rows[int(w)]], np.int32).reshape(-1, 6)
        data = rng.integers(-2 ** 15, 2 ** 15,
                            (len(meta), 110)).astype(np.int16)
        parts.append((batch, data, meta))
    return dict(parts=parts, win_left=np.array([10 ** 9, 2 * 10 ** 9,
                                                3 * 10 ** 9], np.int64),
                n_samples=T, n_rows=C)


def any_case(name):
    return order_case(name) if name in ORDER_CASES else row_case(name)


def torch_parts(case, dev='cpu'):
    return [(b, torch.as_tensor(d, device=dev), torch.as_tensor(m, device=dev))
            for b, d, m in case['parts']]


def twin(case):
    return round_order_ref(torch_parts(case), case['win_left'],
                           n_samples=case['n_samples'],
                           n_rows=case['n_rows'])


ALL_CASES = ORDER_CASES + ROW_CASES


@pytest.mark.parametrize('name', ALL_CASES)
def test_stable_start_sort_is_the_lexsort(name):
    """Within each window, K4's records sorted stably by start alone, in
    their source order, are wfsim_tpu's lexsort order and the packed-key
    sort's: K4 writes a window's records by channel, then start, and no
    channel has two records at one start."""
    case = any_case(name)
    parts = case['parts']
    metas = [m for _, _, m in parts]
    meta = np.concatenate(metas)
    W = np.concatenate([np.asarray(b, np.int64)[m[:, 0]]
                        for b, _, m in parts])
    # K4's source order within each window: (channel, start), unique keys
    for m in metas:
        key = m[:, 0].astype(np.int64) * 2 ** 40 + m[:, 1] * 2 ** 20 + m[:, 2]
        assert (np.diff(key) > 0).all()
    perm = []
    for w in range(len(case['win_left'])):
        src = np.flatnonzero(W == w)
        if len(src):
            assert (np.diff(src) == 1).all()           # one run a window
        perm.append(src[np.argsort(meta[src, 2], kind='stable')])
    perm = np.concatenate(perm)
    lex = np.lexsort((meta[:, 1], meta[:, 2], W))
    np.testing.assert_array_equal(perm, lex)
    np.testing.assert_array_equal(perm, twin(case)['perm'].numpy())
    if name == 'long window':
        assert np.bincount(W).max() > 10_000
    if name == 'he channels':
        assert meta[:, 1].max() >= HE_CHANNELS[0]
    if name == 'ties':
        same = np.unique(np.stack([W, meta[:, 2]]), axis=1).shape[1]
        assert same < len(W) // 4


def warp_lower_bound(col, b):
    """The kernel's warp search (warp_lower_bound): the first index of
    ``col`` (non-decreasing) holding a value >= b, by 32 probes a step
    while more than 32 candidates remain, then one probe a lane."""
    lane = np.arange(32)
    lo, hi = 0, len(col)
    steps = 0
    while hi - lo > 32:
        pos = lo + (hi - lo) * (lane + 1) // 33
        k = int((col[pos] < b).sum())
        lo, hi = (pos[k - 1] + 1 if k > 0 else lo), (pos[k] if k < 32 else hi)
        steps += 1
    pos = lo + lane
    return lo + int(((pos < hi) & (col[np.minimum(pos, len(col) - 1)] < b)
                     ).sum()) if len(col) else 0, steps


def counting_ranks(start, chan, bits_c, rng, bins=BINS):
    """The kernel's counting rank of a chunk: a histogram of the starts >>
    shift (the least shift that fits the largest start in ``bins``) and
    its exclusive scan; each record takes a slot of its bin in an
    arbitrary order (here ``rng``'s) and puts (start's low shift bits,
    channel, index) there, 12 bits for the index; its rank is its bin's
    first slot plus the values in its bin's slots below its own.  Returns
    (ranks, shift, the bins' first slots and end)."""
    n = len(start)
    shift = 0
    while int(start.max()) >> shift >= bins:
        shift += 1
    b = start >> shift
    hist = np.bincount(b, minlength=int(b.max()) + 1)
    off = np.concatenate([[0], np.cumsum(hist)])
    p0 = off[b]
    mine = ((((start & ((1 << shift) - 1)).astype(np.int64) << bits_c)
             | chan) << 12) | np.arange(n)
    assert mine.max(initial=0) < 2 ** 32
    cur = off[:-1].copy()
    tie = np.zeros(n, np.int64)
    for i in rng.permutation(n):
        tie[cur[b[i]]] = mine[i]
        cur[b[i]] += 1
    end = cur[b]
    return np.array([p0[i] + int((tie[p0[i]:end[i]] < mine[i]).sum())
                     for i in range(n)], np.int64), shift, off


def chunk_ranks(m, c0, cap, bits_c, rng, bins=BINS):
    """The kernel on chunk [c0, c0 + cap) of a long window whose meta rows
    are ``m``: the chunk ranked by counting, its words (key << 32 | index
    in the window) in rank order, each other record counted at its place
    among them (the bins before its bin, then a search of its bin's
    slots; none past the last bin), each chunk record's rank its place
    plus the others counted at or before it.  Returns (the chunk's
    indices in the window in rank order, their ranks in the window)."""
    n = len(m)
    k = min(cap, n - c0)
    key = ((m[:, 2].astype(np.uint64) << np.uint64(bits_c))
           | m[:, 1].astype(np.uint64))
    words = (key << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    rank, shift, off = counting_ranks(m[c0:c0 + k, 2], m[c0:c0 + k, 1],
                                      bits_c, rng, bins)
    s = np.zeros(k, np.uint64)
    s[rank] = words[c0:c0 + k]
    others = np.r_[0:c0, c0 + k:n]
    b = m[others, 2].astype(np.int64) >> shift
    y = words[others][b < len(off) - 1]
    b = b[b < len(off) - 1]
    # the search of a bin's slots: the lower bound of y, within the bin
    p = np.clip(np.searchsorted(s, y), off[b], off[b + 1])
    cnt = np.bincount(p[p < k], minlength=k)
    return (s & np.uint64(0xffffffff)).astype(np.int64), \
        np.arange(k) + np.cumsum(cnt)


def chunk_blocks(counts, cap, n_rec):
    """The sort launch's grid (a block a window, one for every ``cap``
    records of the round) and each block's (window, chunk), as the kernel
    maps it: block w < W takes window w's first chunk, a later block the
    chunk past the first of the window its xbase search finds, or
    nothing (None)."""
    n_win = len(counts)
    extra = np.where(counts > cap, (counts - 1) // cap, 0)
    xbase = np.concatenate([[0], np.cumsum(extra)])
    out = []
    for b in range(n_win + n_rec // cap):
        if b < n_win:
            out.append((b, 0))
            continue
        e = b - n_win
        lo, hi = 0, n_win
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            lo, hi = (mid, hi) if xbase[mid] <= e else (lo, mid)
        out.append((lo, 1 + e - int(xbase[lo])) if e < xbase[n_win]
                   else None)
    return out


def emulate_round_order(case, cap=CAP, bins=BINS):
    """csrc/round_order.cu in numpy: the count launch (each batch window's
    first record by the warp search, then the last block: counts, first
    records, the scan into bases) and the sort launch, block by block
    (``chunk_blocks``): a window of at most ``cap`` records ranked by
    counting its starts in ``bins`` bins, a longer window's chunks each
    by ``chunk_ranks``.  Returns perm, win, counts, the paths taken
    (counting, coarse where a start was shifted, chunked) and the chunks
    each block took."""
    parts, win_left = case['parts'], case['win_left']
    n_win = len(win_left)
    bits_c = max(int(case['n_rows'] - 1).bit_length(), 1)
    metas = [m for _, _, m in parts]
    first_rec = np.concatenate([[0], np.cumsum([len(m) for m in metas])])
    counts = np.zeros(n_win, np.int64)
    first = np.zeros(n_win, np.int64)
    local = np.zeros(n_win, np.int64)
    wbatch = np.zeros(n_win, np.int64)
    for j, (batch, _d, m) in enumerate(parts):
        lb = [warp_lower_bound(m[:, 0], b)[0] for b in range(len(batch))]
        lb.append(len(m))
        for b, w in enumerate(batch):
            counts[w] = lb[b + 1] - lb[b]
            first[w] = first_rec[j] + lb[b]
            local[w], wbatch[w] = lb[b], j
    base = np.concatenate([[0], np.cumsum(counts)])
    N = int(base[-1])
    perm = np.full(N, -1, np.int64)
    win = np.full(N, -1, np.int32)
    rng = np.random.default_rng(7)
    paths, taken = set(), []
    for block in chunk_blocks(counts, cap, N):
        if block is None or not counts[block[0]]:
            continue
        w, c = block
        n = int(counts[w])
        taken.append(block)
        m = metas[wbatch[w]][local[w]:local[w] + n]
        c0, c1 = c * cap, min(n, c * cap + cap)
        win[first[w] + c0:first[w] + c1] = w
        if n <= cap:
            rank, shift, _off = counting_ranks(m[:, 2], m[:, 1], bits_c, rng,
                                               bins)
            perm[base[w] + rank] = first[w] + np.arange(n)
            paths.add('coarse' if shift else 'counting')
            continue
        idx, rank = chunk_ranks(m, c0, cap, bits_c, rng, bins)
        perm[base[w] + rank] = first[w] + idx
        paths.add('chunked')
    return dict(perm=perm, win=win, counts=counts, paths=paths, taken=taken)


@pytest.mark.parametrize('name,cap,bins', [
    (name, CAP, BINS) for name in ALL_CASES] + [
    (name, CAP, 16) for name in ORDER_CASES] + [
    ('long window', 64, BINS), ('ties', 64, BINS)])
def test_emulation_matches_twin(name, cap, bins):
    """The kernel's decomposition gives the plain version's permutation,
    windows and counts exactly: by counting where a window's starts fit
    the bins, by counting shifted starts where they do not (16 bins), and
    by chunks ranked on blocks of their own (a chunk of 64); the grid's
    blocks take each chunk of each window with records exactly once."""
    case = any_case(name)
    ref = twin(case)
    emu = emulate_round_order(case, cap, bins)
    for k in ('perm', 'win', 'counts'):
        np.testing.assert_array_equal(emu[k], ref[k].numpy(), err_msg=k)
    want = [(w, c) for w, n in enumerate(emu['counts'])
            for c in range(-(-int(n) // cap))]
    assert sorted(emu['taken']) == want
    if name == 'long window':
        assert 'chunked' in emu['paths']
    if bins == 16 and name != 'long window':
        assert 'coarse' in emu['paths']


@pytest.mark.parametrize('n,repeat', [(0, 1), (5, 1), (33, 1), (1000, 7),
                                      (100_000, 300)])
def test_warp_search_is_searchsorted(n, repeat):
    rng = np.random.default_rng(n)
    col = np.sort(rng.integers(0, max(n // repeat, 1), n)).astype(np.int32)
    steps_max = 0
    for b in range(-1, int(col.max(initial=0)) + 3):
        got, steps = warp_lower_bound(col, b)
        assert got == np.searchsorted(col, b, side='left')
        steps_max = max(steps_max, steps)
    assert steps_max <= 4


@pytest.mark.parametrize('name', ('several batches', 'no records'))
def test_counts_and_rows_follow_the_lexsort(name):
    """round_order's plain version and round_records on the CPU: counts
    of each window and rows equal to wfsim_tpu's rule restated."""
    case = any_case(name)
    recs, bounds = lexsort_records(case['parts'], case['win_left'])
    o = twin(case)
    np.testing.assert_array_equal(o['counts'].numpy(), np.diff(bounds))
    rows, counts = dg.round_records(torch_parts(case), case['win_left'],
                                    dt=DT, n_samples=case['n_samples'],
                                    n_rows=case['n_rows'])
    assert rows.numpy().tobytes() == recs.tobytes()
    np.testing.assert_array_equal(counts, np.diff(bounds))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors never reach the ordering kernel; parts are emptied."""
    from wfsim_tpu_torch import _build

    def no_library():
        raise AssertionError('the kernel library was loaded on the CPU')
    monkeypatch.setattr(_build, 'load_library', no_library)
    case = order_case('several batches')
    k = _build.KERNELS['wfsim_round_order']
    before = k.launches
    parts = torch_parts(case)
    o = round_order(parts, case['win_left'], n_samples=case['n_samples'],
                    n_rows=case['n_rows'])
    assert parts == [] and k.launches == before
    ref = twin(case)
    for key in ('perm', 'win', 'counts'):
        assert torch.equal(o[key], ref[key])


def test_emulated_constants_are_the_kernels():
    src = (Path(dg.__file__).resolve().parents[1] / 'csrc'
           / 'round_order.cu').read_text()
    assert f'constexpr int kCap = {CAP};' in src
    assert f'constexpr int kBins = {BINS};' in src
    assert f'constexpr int kSortThreads = {SORT_THREADS};' in src
