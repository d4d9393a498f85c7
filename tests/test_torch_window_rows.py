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
- the emulation (the host plan, per segment counts, minima and maxima, a
  window of one segment taken at once, the chain of group, window and
  batch scans for longer ones, each warp's run of its segment with its
  offsets from a scan over the warps and the channels and its ranks
  within 32-photon steps, the segment staged in row order) against the
  twin: every output exact, under the kernel's segment of 8,192 photons
  and under short segments that cut windows into many groups;
- the plan: every window's photons covered once, in order, by segments
  of at most the segment length, in groups that stay inside a window; a
  window without photons has one empty segment;
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
from wfsim_tpu_torch.pipeline.digitize import (
    WINDOW_GROUP, WINDOW_SEGMENT, window_photons, window_photons_ref,
    window_rows_plan)

#: threads, warps and photons a thread of a block of the kernel
#: (csrc/window_rows.cu kThreads, kPer)
THREADS = 512
WARPS = THREADS // 32
PER = 16

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
    """csrc/window_rows.cu in numpy: the host plan (segments of
    ``segment`` photons, grouped by WINDOW_GROUP within a window), the
    count pass (a segment's per-channel counts, minima and maxima of
    t // dt; a window of one segment takes its extents, row offsets and
    total from them at once, a longer one through its chain of scans: the
    last segment of a group turns the segments' counts into prefixes
    within the group, the last group of the window the groups' into
    prefixes within the window, with the extents and row offsets; the
    last window the windows' totals into bases), then the place pass
    (each warp a contiguous run of PER x 32 photons of its segment: its
    channel counts, their prefix over the warps, the segment's channel
    offsets, each photon's slot in the segment its channel's offset plus
    the warps' before it plus its rank among the lower lanes of its
    32-photon step; the slot's destination its channel's first for the
    segment plus its place in the channel's run); returns
    window_photons' dict as numpy arrays."""
    C, dt, T = const.n_tpc_pmts, const.sample_duration, n_samples
    left_pad = (const.samples_to_store_before
                + const.samples_before_pulse_center + const.trigger_window)
    right_pad = (const.samples_to_store_after
                 + const.samples_after_pulse_center + const.trigger_window)
    B = pieces.shape[0]
    G = WINDOW_GROUP
    n_out = int(pieces[:, :, 1].sum())
    pstart, plan = window_rows_plan(pieces, segment)
    n_seg = len(plan)
    n_grp = int(plan[-1, 5] + -(-plan[-1, 2] // G))
    big = 2 ** 30

    def segment_of(s):
        w, s0, nw, j0, ln, g0 = (int(x) for x in plan[s])
        k = s - s0
        gs0 = s0 + (k // G) * G
        return dict(w=w, nw=nw, k=k, g=g0 + k // G, gs0=gs0,
                    gn=min(G, s0 + nw - gs0), wg0=g0, wgn=-(-nw // G), j0=j0,
                    len=ln)

    def photons(sg):
        # every piece of the window staged; a photon's piece the last
        # whose start is <= its index in the window
        w, j0, ln = sg['w'], sg['j0'], sg['len']
        j = j0 + np.arange(ln)
        pc = np.searchsorted(pstart[w], j, side='right') - 1
        a = pieces[w, pc, 0] + j - pstart[w, pc]
        c = ch[a]
        return (np.where((c >= 0) & (c < C), c, -1),
                wrap32(t[a].astype(np.int64) + pieces[w, pc, 2]), g[a])

    def extents(w, lo, hi):
        rows = w * C + np.arange(C)
        has[rows] = hi >= lo
        left[rows] = np.clip(wrap32(lo - left_pad), 0, T - 1)
        right[rows] = np.clip(wrap32(hi + right_pad), 0, T - 1)

    segs = [segment_of(s) for s in range(n_seg)]
    sc = np.zeros((n_seg, C), np.int64)
    smn = np.full((n_seg, C), big, np.int64)
    smx = np.full((n_seg, C), -big, np.int64)
    for s, sg in enumerate(segs):
        c, tt, _g = photons(sg)
        k = c >= 0
        np.add.at(sc[s], c[k], 1)
        np.minimum.at(smn[s], c[k], tt[k] // dt)
        np.maximum.at(smx[s], c[k], tt[k] // dt)
    row_ptr = np.full(B * C + 1, -1, np.int64)
    left = np.full(B * C, -1, np.int64)
    right = np.full(B * C, -1, np.int64)
    has = np.zeros(B * C, bool)
    rowoff = np.zeros((B, C), np.int64)
    wtot = np.zeros(B, np.int64)
    gc = np.zeros((n_grp, C), np.int64)
    gmn = np.full((n_grp, C), big, np.int64)
    gmx = np.full((n_grp, C), -big, np.int64)
    # windows of one segment: at once
    for s, sg in enumerate(segs):
        if sg['nw'] == 1:
            extents(sg['w'], smn[s], smx[s])
            wtot[sg['w']] = sc[s].sum()
    # the last segment of each group of a longer window
    for sg in segs:
        if sg['nw'] == 1 or sg['k'] % G:
            continue
        rng = slice(sg['gs0'], sg['gs0'] + sg['gn'])
        v = sc[rng].copy()
        sc[rng] = np.cumsum(v, axis=0) - v
        gc[sg['g']] = v.sum(axis=0)
        gmn[sg['g']] = smn[rng].min(axis=0)
        gmx[sg['g']] = smx[rng].max(axis=0)
    # the last group of each longer window
    for sg in segs:
        if sg['nw'] == 1 or sg['k']:
            continue
        w, rng = sg['w'], slice(sg['wg0'], sg['wg0'] + sg['wgn'])
        v = gc[rng].copy()
        gc[rng] = np.cumsum(v, axis=0) - v
        tot = v.sum(axis=0)
        extents(w, gmn[rng].min(axis=0), gmx[rng].max(axis=0))
        rowoff[w] = np.cumsum(tot) - tot
        wtot[w] = tot.sum()
    # the last window
    wbase = np.concatenate([[0], np.cumsum(wtot)])
    kept = int(wbase[B])

    out_t = np.full(n_out, -1, np.int32)
    out_g = np.full(n_out, np.nan, np.float32)
    run = PER * 32
    for s, sg in enumerate(segs):
        w = sg['w']
        c_all, t_all, g_all = photons(sg)
        ln = sg['len']
        cnt = np.zeros((WARPS, C), np.int64)
        for k in range(WARPS):
            c = c_all[k * run:min(ln, (k + 1) * run)]
            np.add.at(cnt[k], c[c >= 0], 1)
        tot = cnt.sum(axis=0)
        first = np.cumsum(tot) - tot
        cur = np.cumsum(cnt, axis=0) - cnt
        if sg['nw'] == 1:
            delta = np.full(C, wbase[w])
            if sg['k'] == 0:
                row_ptr[w * C:(w + 1) * C] = wbase[w] + first
        else:
            delta = wbase[w] + rowoff[w] + gc[sg['g']] + sc[s] - first
            if sg['k'] == 0:
                row_ptr[w * C:(w + 1) * C] = wbase[w] + rowoff[w]
        if sg['k'] == 0 and w == B - 1:
            row_ptr[B * C] = kept
        for k in range(WARPS):
            for base in range(k * run, min(ln, (k + 1) * run), 32):
                c = np.full(32, -1)
                c[:min(32, ln - base)] = c_all[base:min(base + 32, ln)]
                same = c[:, None] == c[None, :]
                lower = np.arange(32)[None, :] < np.arange(32)[:, None]
                rank = (same & lower).sum(axis=1)
                for i in np.nonzero(c >= 0)[0]:
                    slot = first[c[i]] + cur[k, c[i]] + rank[i]
                    out_t[delta[c[i]] + slot] = t_all[base + i]
                    out_g[delta[c[i]] + slot] = g_all[base + i]
                np.add.at(cur[k], c[c >= 0], 1)
    out_t[kept:] = 0
    out_g[kept:] = 0.0
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
    """Each window's segments are consecutive, cover its photons once in
    order with at most ``segment`` each (one empty segment for a window
    without photons), and their groups of WINDOW_GROUP stay inside the
    window."""
    pieces = window_case(name)[3]
    B = len(pieces)
    for segment in (WINDOW_SEGMENT, 100, 1):
        pstart, plan = window_rows_plan(pieces, segment)
        n_win = pieces[:, :, 1].sum(axis=1)
        assert np.array_equal(pstart[:, 0], np.zeros(B))
        assert np.array_equal(pstart[:, 1:],
                              np.cumsum(pieces[:, :-1, 1], axis=1))
        g_next = 0
        for w in range(B):
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
            assert (mine[:, 5] == g_next).all()
            g_next += -(-nw // WINDOW_GROUP)


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
    assert f'constexpr int kPer = {PER};' in src
    assert f'constexpr int kGroup = {WINDOW_GROUP};' in src
    assert THREADS * PER == WINDOW_SEGMENT
