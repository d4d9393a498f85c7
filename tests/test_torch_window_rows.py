"""The arena gather and channel extents of a digitize batch
(``pipeline.digitize.window_photons``, kernel K17 ``csrc/window_rows.cu``)
on the CPU: its twin ``window_photons_ref`` against wfsim_tpu's
``gather_digitize``, a numpy emulation of the kernel's two passes against
the twin, the host plan, and the pipeline's hand-over.

Tolerances, per quantity:

- the twin against wfsim_tpu's ``gather_digitize`` + ``pack_records`` on
  the same arena and piece table (``WINDOW_CASES``): ``left_all`` equal;
  ``right_all`` and ``has`` equal to the windows wfsim_tpu's grid shows
  (an in-window sample holds baseline + ADC > 0, one outside it the ADC
  <= 0; no sample reaches 0 at these gains); the grid, ZLE intervals and
  records bitwise (as tests/test_torch_digitize.py, tie samples 0);
- the emulation (the host plan, per segment counts, minima and maxima,
  the window bases, the block scan over channels, each sub-tile's ranks
  within a warp plus the counts of the warps before it) against the
  twin: every output exact, under the kernel's segment of 8,192 photons
  and under short segments that cut windows into many;
- the plan: every window's photons covered once, in order, by segments
  of at most the segment length; a window without photons has one empty
  segment;
- a channel at or past C is dropped, as channel -1 is, by the twin and
  the emulation alike (exact);
- the pipeline hands each batch's host piece table to
  ``gather_digitize``; a CPU tensor never reaches the kernel binding.

The cases are numpy only, made from a seed (``window_case``), so that
tests/test_torch_cuda.py can import them on the card's machine, which has
no JAX: JAX is imported inside the tests that use it.
"""
import numpy as np
import pytest
import torch

from wfsim_tpu_torch import _build
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import build_constants
from wfsim_tpu_torch.pipeline import digitize as dg
from wfsim_tpu_torch.pipeline.digitize import (WINDOW_SEGMENT, window_photons,
                                               window_photons_ref,
                                               window_rows_plan)

#: threads a block of the kernel (csrc/window_rows.cu kThreads)
THREADS = 256

WINDOW_CASES = ('pieces', 'ties', 'empty', 'skewed')
#: the cases wfsim_tpu's gather_digitize runs too (one compile each)
JAX_CASES = ('pieces', 'ties', 'empty')


def window_case(name):
    """(t, ch, gain, pieces, T) of a case: photons on 16 channels of the
    arena, some pieces not referenced, channel -1 among them.

    - pieces: four windows of up to four pieces with t_offsets: window 0
      three pieces and a padding piece, window 1 one piece whose photons
      are all dropped, window 2 only padding pieces, window 3 two pieces
      with a padding piece between them;
    - ties: two windows whose photons share a few times on 8 channels;
    - empty: three windows, every count 0;
    - skewed: window 0 holds 100,003 photons in three pieces, two small
      windows after it.
    """
    rng = np.random.default_rng(WINDOW_CASES.index(name) + 17)
    T = 512
    if name == 'ties':
        n = 900
        t = rng.choice([640, 1200, 1205, 2300], n).astype(np.int32)
        ch = rng.integers(0, 8, n).astype(np.int32)
        ch[rng.random(n) < 0.05] = -1
        pieces = np.array([[[0, 500, 0], [500, 0, 0]],
                           [[500, 300, 30], [800, 100, -7]]], np.int64)
    else:
        n = 120_000 if name == 'skewed' else 1_500
        t = rng.integers(100, 4_000, n).astype(np.int32)
        ch = rng.integers(0, 16, n).astype(np.int32)
        ch[rng.random(n) < 0.04] = -1
        if name == 'pieces':
            ch[300:420] = -1
            pieces = np.array([
                [[0, 150, 0], [160, 90, 1200], [260, 30, 9], [0, 0, 0]],
                [[300, 120, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                [[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                [[500, 400, 40], [0, 0, 0], [1000, 377, 800], [0, 0, 0]]],
                np.int64)
        elif name == 'empty':
            pieces = np.zeros((3, 2, 3), np.int64)
            pieces[:, :, 0] = 5
        else:
            pieces = np.array([
                [[0, 40_001, 0], [50_000, 60_000, 300], [40_001, 2, -50]],
                [[110_000, 700, 0], [0, 0, 0], [0, 0, 0]],
                [[111_000, 9_000, 11], [0, 0, 0], [0, 0, 0]]], np.int64)
    g = rng.uniform(1e6, 3e6, n).astype(np.float32)
    return t, ch, g, pieces, T


@pytest.fixture(scope='module')
def const():
    return build_constants(default_config())


def wrap32(x):
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(
        np.int32)


def emulate_window_rows(const, t, ch, g, pieces, n_samples,
                        segment=WINDOW_SEGMENT):
    """csrc/window_rows.cu in numpy: the host plan, the count pass (a
    segment's per-channel counts, minima and maxima of t // dt, its kept
    total) and the place pass (the window's base from the totals of the
    segments before it, each channel's window total and its count in the
    window's earlier segments, the block scan over channels, then each
    sub-tile of 256 photons: a photon's slot is its channel's cursor plus
    the count of its channel in the warps before its warp plus its rank
    among the lower lanes of its warp); returns window_photons' dict as
    numpy arrays."""
    C, dt, T = const.n_tpc_pmts, const.sample_duration, n_samples
    left_pad = (const.samples_to_store_before
                + const.samples_before_pulse_center + const.trigger_window)
    right_pad = (const.samples_to_store_after
                 + const.samples_after_pulse_center + const.trigger_window)
    B = pieces.shape[0]
    n_out = int(pieces[:, :, 1].sum())
    pstart, plan = window_rows_plan(pieces, segment)
    n_seg = len(plan)
    big = 2 ** 30
    cnt = np.zeros((n_seg, C), np.int64)
    mn = np.full((n_seg, C), big, np.int64)
    mx = np.full((n_seg, C), -big, np.int64)

    def photons(s):
        w, _s0, _nw, j0, ln = plan[s]
        j = j0 + np.arange(ln)
        pc = np.searchsorted(pstart[w], j, side='right') - 1
        a = pieces[w, pc, 0] + j - pstart[w, pc]
        c = ch[a]
        return (np.where((c >= 0) & (c < C), c, -1),
                wrap32(t[a].astype(np.int64) + pieces[w, pc, 2]), g[a])

    for s in range(n_seg):
        c, tt, _g = photons(s)
        k = c >= 0
        np.add.at(cnt[s], c[k], 1)
        np.minimum.at(mn[s], c[k], tt[k] // dt)
        np.maximum.at(mx[s], c[k], tt[k] // dt)
    seg_total = cnt.sum(axis=1)

    out_t = np.full(n_out, -1, np.int32)
    out_g = np.full(n_out, np.nan, np.float32)
    row_ptr = np.full(B * C + 1, -1, np.int64)
    left = np.full(B * C, -1, np.int64)
    right = np.full(B * C, -1, np.int64)
    has = np.zeros(B * C, bool)
    total = int(seg_total.sum())
    warp = np.arange(THREADS) // 32
    for s in range(n_seg):
        w, s0, nw, _j0, ln = plan[s]
        k = s - s0
        before = int(seg_total[:s0].sum())
        tot = cnt[s0:s0 + nw].sum(axis=0)
        pre = cnt[s0:s0 + k].sum(axis=0)
        off = before + np.cumsum(tot) - tot
        cursor = off + pre
        if k == 0:
            rows = w * C + np.arange(C)
            lo, hi = mn[s0:s0 + nw].min(axis=0), mx[s0:s0 + nw].max(axis=0)
            row_ptr[rows] = off
            has[rows] = hi >= lo
            left[rows] = np.clip(wrap32(lo - left_pad), 0, T - 1)
            right[rows] = np.clip(wrap32(hi + right_pad), 0, T - 1)
            if w == B - 1:
                row_ptr[B * C] = before + tot.sum()
        c_all, t_all, g_all = photons(s)
        # a tile of the kernel is sub-tiles of THREADS consecutive
        # photons, taken in order
        for base in range(0, ln, THREADS):
            c = np.full(THREADS, -1)
            n = min(THREADS, ln - base)
            c[:n] = c_all[base:base + n]
            same = c[:, None] == c[None, :]
            earlier = np.arange(THREADS)[None, :] < np.arange(THREADS)[:, None]
            in_warp = warp[:, None] == warp[None, :]
            rank = (same & earlier & in_warp).sum(axis=1)
            warps_before = (same & (warp[None, :] < warp[:, None])).sum(axis=1)
            for i in np.nonzero(c >= 0)[0]:
                pos = cursor[c[i]] + warps_before[i] + rank[i]
                out_t[pos] = t_all[base + i]
                out_g[pos] = g_all[base + i]
            np.add.at(cursor, c[c >= 0], 1)
    out_t[total:] = 0
    out_g[total:] = 0.0
    return dict(t=out_t, gain=out_g, row_ptr=row_ptr, ch_left=left,
                ch_right=right, has=has)


def twin_numpy(const, case):
    t, ch, g, pieces, T = case
    ph = window_photons_ref(const, *(torch.from_numpy(a) for a in (t, ch, g)),
                            pieces, n_samples=T)
    return {k: v.numpy() for k, v in ph.items()}


@pytest.mark.parametrize('name,segment', [
    (name, segment) for name in WINDOW_CASES
    for segment in (WINDOW_SEGMENT, 1000, 37)
    if (name, segment) != ('skewed', 37)])   # 2,700 segments: slow in numpy
def test_emulation_matches_twin(const, name, segment):
    """The kernel's decomposition gives the twin's outputs exactly: rows
    in arena order within a row, the extents, the zero tail."""
    case = window_case(name)
    ref = twin_numpy(const, case)
    emu = emulate_window_rows(const, *case[:4], case[4], segment=segment)
    for k in ('t', 'gain', 'row_ptr', 'ch_left', 'ch_right', 'has'):
        assert ref[k].shape == emu[k].shape, k
        np.testing.assert_array_equal(ref[k], emu[k].astype(ref[k].dtype),
                                      err_msg=k)


@pytest.mark.parametrize('name', WINDOW_CASES)
def test_twin_row_order_oracle(const, name):
    """The twin's photons: each window's kept photons in arena order, sorted
    stably by channel, then a zero tail; row_ptr their row counts."""
    t, ch, g, pieces, T = case = window_case(name)
    ref = twin_numpy(const, case)
    C = const.n_tpc_pmts
    ts, gs, rows = [], [], []
    for w in range(pieces.shape[0]):
        for lo, n, off in pieces[w]:
            sl = slice(lo, lo + n)
            keep = ch[sl] >= 0
            ts.append(wrap32(t[sl][keep].astype(np.int64) + off))
            gs.append(g[sl][keep])
            rows.append(w * C + ch[sl][keep])
    rows = np.concatenate(rows).astype(np.int64)
    order = np.argsort(rows, kind='stable')
    n_keep = len(rows)
    np.testing.assert_array_equal(ref['t'][:n_keep], np.concatenate(ts)[order])
    np.testing.assert_array_equal(ref['gain'][:n_keep],
                                  np.concatenate(gs)[order])
    assert not ref['t'][n_keep:].any() and not ref['gain'][n_keep:].any()
    assert len(ref['t']) == int(pieces[:, :, 1].sum())
    np.testing.assert_array_equal(
        ref['row_ptr'], np.concatenate([[0], np.cumsum(np.bincount(
            rows, minlength=pieces.shape[0] * C))]))


@pytest.fixture(scope='module')
def jax_setups():
    """tests/test_torch_digitize.py's setups: wfsim_tpu's and the port's
    (config, params, constants) on the CPU."""
    from wfsim_tpu.config import default_config as jax_default_config
    from wfsim_tpu.models.params import (build_params as jax_build_params,
                                         build_constants as jax_constants)
    from wfsim_tpu.resources.loader import load_config as jax_load_config
    from wfsim_tpu_torch.models.params import build_params
    from wfsim_tpu_torch.resources import load_config
    cj = jax_default_config()
    c = default_config()
    return ((cj, jax_build_params(cj, jax_load_config(cj)), jax_constants(cj)),
            (c, build_params(c, load_config(c), 'cpu'), build_constants(c)))


@pytest.mark.parametrize('name', JAX_CASES)
def test_twin_matches_wfsim_tpu(const, jax_setups, name):
    """window_photons_ref inside the port's gather_digitize against
    wfsim_tpu's gather_digitize on the same arena and piece table: the
    extents, the grid and the records."""
    from .test_torch_digitize import assert_same, run_both
    t, ch, g, pieces, T = window_case(name)
    jx, th = run_both(jax_setups, t, ch, g, pieces, T)
    B, C = pieces.shape[0], const.n_tpc_pmts
    ph = twin_numpy(const, (t, ch, g, pieces, T))
    np.testing.assert_array_equal(jx['left'], ph['ch_left'].reshape(B, C))
    in_win = jx['grid'] > 0
    has = in_win.any(axis=2)
    last = T - 1 - np.argmax(in_win[:, :, ::-1], axis=2)
    first = np.argmax(in_win, axis=2)
    np.testing.assert_array_equal(has, ph['has'].reshape(B, C))
    np.testing.assert_array_equal(last[has], ph['ch_right'].reshape(B, C)[has])
    np.testing.assert_array_equal(first[has], ph['ch_left'].reshape(B, C)[has])
    t_win, ch_win, g_win = [], [], []
    for w in range(B):
        tw, cw, gw = [], [], []
        for lo, n, off in pieces[w]:
            sl = slice(lo, lo + n)
            keep = ch[sl] >= 0
            tw.append(t[sl][keep] + off)
            cw.append(ch[sl][keep])
            gw.append(g[sl][keep])
        t_win.append(np.concatenate(tw))
        ch_win.append(np.concatenate(cw))
        g_win.append(np.concatenate(gw))
    assert_same(jax_setups[1][0], jx, th, t_win, ch_win, g_win, T)
    if name != 'empty':
        assert has.any() and len(th['rec_meta'])


@pytest.mark.parametrize('name', WINDOW_CASES)
def test_plan_covers_each_window_once(name):
    pieces = window_case(name)[3]
    for segment in (WINDOW_SEGMENT, 100, 1):
        pstart, plan = window_rows_plan(pieces, segment)
        n_win = pieces[:, :, 1].sum(axis=1)
        assert np.array_equal(pstart[:, 0], np.zeros(len(pieces)))
        for w in range(len(pieces)):
            mine = plan[plan[:, 0] == w]
            s0, nw = mine[0, 1], mine[0, 2]
            assert len(mine) == nw and (mine[:, 1] == s0).all()
            assert np.array_equal(np.nonzero(plan[:, 0] == w)[0],
                                  s0 + np.arange(nw))
            assert (mine[:, 4] <= segment).all()
            assert np.array_equal(mine[:, 3], np.concatenate(
                [[0], np.cumsum(mine[:-1, 4])]))
            assert mine[:, 4].sum() == n_win[w]
            assert n_win[w] or (nw == 1 and mine[0, 4] == 0)


def test_empty_batch(const):
    """No window at all: empty outputs and row_ptr [0]."""
    z = torch.zeros(0, dtype=torch.int32)
    ph = window_photons(const, z, z, torch.zeros(0),
                        np.zeros((0, 3, 3), np.int64), n_samples=64)
    assert ph['row_ptr'].tolist() == [0]
    assert all(ph[k].numel() == 0 for k in ('t', 'gain', 'ch_left',
                                           'ch_right', 'has'))


def test_cpu_tensors_never_reach_the_kernel(const, monkeypatch):
    """On CPU tensors window_photons runs the twin: the kernel library is
    never loaded and the launch count does not move."""
    def no_library():
        raise AssertionError('the kernel library was loaded on the CPU')
    monkeypatch.setattr(_build, 'load_library', no_library)
    k = _build.KERNELS['wfsim_window_rows']
    before = k.launches
    t, ch, g, pieces, T = case = window_case('pieces')
    ph = window_photons(const, *(torch.from_numpy(a) for a in (t, ch, g)),
                        torch.from_numpy(pieces), n_samples=T)
    ref = twin_numpy(const, case)
    for key, v in ph.items():
        np.testing.assert_array_equal(v.numpy(), ref[key])
    assert k.launches == before


def test_checks(const):
    """A piece table of the wrong shape and a piece outside the arena
    raise."""
    t, ch, g, pieces, T = window_case('pieces')
    args = [torch.from_numpy(a) for a in (t, ch, g)]
    with pytest.raises(ValueError, match='need'):
        window_photons(const, *args, pieces[:, :, :2], n_samples=T)
    far = pieces.copy()
    far[0, 0, 0] = len(t) - 10
    with pytest.raises(ValueError, match='arena'):
        window_photons(const, *args, far, n_samples=T)


@pytest.mark.parametrize('segment', [WINDOW_SEGMENT, 37])
def test_channels_past_c_are_dropped(const, segment):
    """A photon whose channel is C or more is dropped, as one of channel -1
    is: the twin's outputs equal those with such channels set to -1, and
    the kernel's decomposition agrees."""
    t, ch, g, pieces, T = window_case('pieces')
    C = const.n_tpc_pmts
    bad = ch.copy()
    used = np.flatnonzero(ch >= 0)[::5]
    bad[used] = C + np.arange(len(used)) % 3 * 500
    got = twin_numpy(const, (t, bad, g, pieces, T))
    minus = ch.copy()
    minus[used] = -1
    ref = twin_numpy(const, (t, minus, g, pieces, T))
    emu = emulate_window_rows(const, t, bad, g, pieces, T, segment=segment)
    assert got['row_ptr'][-1] < twin_numpy(
        const, (t, ch, g, pieces, T))['row_ptr'][-1]
    for k in ('t', 'gain', 'row_ptr', 'ch_left', 'ch_right', 'has'):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], emu[k].astype(got[k].dtype),
                                      err_msg=k)


def test_dispatch_hands_over_host_table(monkeypatch):
    """RawData's digitize dispatch passes each batch's host piece table
    (plan_digitize's numpy array), from which the card's plan and the
    photon total that sizes ``t`` and ``gain`` are made with no read-back;
    the window gather keeps one slot a photon of that table."""
    from wfsim_tpu_torch.pipeline import rawdata
    from .test_torch_record_arena import (PULSE_STARTS, SPLITS,
                                          digitized_rounds, photon_buffers)
    calls, slots = [], []
    real, real_window = rawdata.gather_digitize, dg.window_photons

    def spy(params, const, *args, **kw):
        calls.append(args[3])
        return real(params, const, *args, **kw)

    def spy_window(*args, **kw):
        out = real_window(*args, **kw)
        slots.append(out['t'])
        return out
    monkeypatch.setattr(rawdata, 'gather_digitize', spy)
    monkeypatch.setattr(dg, 'window_photons', spy_window)
    _rd, rounds = digitized_rounds((PULSE_STARTS, photon_buffers()),
                                   SPLITS[2])
    assert len(calls) >= 3
    n_batches = sum(len(plan[2]) for plan, _w, _r in rounds if plan)
    assert len(calls) == n_batches
    for pieces in calls:
        assert isinstance(pieces, np.ndarray) and pieces[:, :, 1].sum() > 0
    assert [len(t) for t in slots] == [int(p[:, :, 1].sum()) for p in calls]


def test_emulated_block_is_the_kernels():
    """The block emulated here (its warps and sub-tiles) is the kernel's."""
    from pathlib import Path
    src = (Path(dg.__file__).resolve().parents[1] / 'csrc'
           / 'window_rows.cu').read_text()
    assert f'constexpr int kThreads = {THREADS};' in src
