"""The truth sums of wfsim_tpu_torch's PMT response — the row kernel
(``wfsim_pmt_row_truth``: the truth sums and the time statistics, K8 row
truth) and the per-PMT kernel (``wfsim_pmt_row_truth_per_pmt``, K16) of
``csrc/pmt_response.cu`` — emulated in numpy and held against their
unchanged plain twins on the cases to which the kernels are sensitive.

The kernels sum exact integers, so their order does not matter: counts;
raw areas as int64 multiples of 2^-32 (``AREA_SCALE``); the time moments
as sum(t) and sum(t^2) modulo 2^64 over each warp's chunk of photons,
combined across chunks by wrapping adds and shifted to the row minimum at
the end.  A row outside either range (count x span^2 >= 2^62; an area term
below 2^-9 or count x the largest above 2^30) takes a float64 second pass
in a fixed order.  The emulation here does the same arithmetic
(``emulate_row_truth``, ``emulate_per_pmt``), in uint64 numpy arrays that
wrap as the kernel's registers do, and the second pass in the kernel's
order (lanes strided over the row, then lane 0's butterfly; the per-PMT
areas in photon order).  tests/test_torch_cuda.py holds the card's outputs
to it bitwise.

Here the emulation equals the twins (``pulse_truth_ref``,
``photon_time_stats_ref``, ``pulse_truth_per_pmt_ref``) bitwise on the
counts and on the moments and areas wherever the twins' own float64 sums
are exact (every case but the second-pass rows, where rtol 1e-12), and
flags exactly the rows ``row_truth_second_pass_ref`` sends to the second
pass.  The cases are numpy only, made from a seed (``truth_case``), so
that the card's machine, which has no JAX, can import them.
"""
import numpy as np
import pytest
import torch

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models import pmt
from wfsim_tpu_torch.models.params import build_params, build_constants
from wfsim_tpu_torch.resources import load_config

TRUTH_CASES = (
    'bench rows',          # empty, no valid photon, one photon, 14 / 176 / 3,076
    'one row of 10^6',     # one large S2 across many chunks and tiles
    'late times',          # times near 2^30
    'moment range',        # a row with count x span^2 >= 2^62
    'area range',          # a term below 2^-9; count x the largest above 2^30
)
#: the rows of each case the second pass takes: (moments, areas)
SECOND_PASS = {'bench rows': (0, 0), 'one row of 10^6': (0, 0),
               'late times': (0, 0), 'moment range': (1, 0),
               'area range': (0, 2)}
WARP = 32


def _setup(detector):
    c = default_config(detector=detector)
    return build_params(c, load_config(c), 'cpu'), build_constants(c)


_SETUPS = {}


def setup_of(detector='XENONnT'):
    """(params, const) on the CPU, built once per detector."""
    if detector not in _SETUPS:
        _SETUPS[detector] = _setup(detector)
    return _SETUPS[detector]


def _rows(rng, lengths, t0, spread, C, gain_ch):
    """Photons of rows of ``lengths``: times t0 + a drifted-S2-like spread
    per row, uniform channels (1 % without one, 2 % more invalid), SPE-like
    gains, 21.9 % double PE."""
    n = int(sum(lengths))
    t = np.concatenate([
        np.clip(rng.normal(t0 + 4_000_000 * i, spread, k)
                + rng.exponential(140, k), -2 ** 31, 2 ** 31 - 1)
        for i, k in enumerate(lengths)]).astype(np.int32) if n else \
        np.zeros(0, np.int32)
    ch = rng.integers(0, C, n).astype(np.int32)
    ch[rng.random(n) < 0.01] = -1
    dpe = rng.random(n) < 0.219
    spe = rng.uniform(0.07, 2.99, n) + np.where(
        dpe, rng.uniform(0.07, 2.99, n), 0.0)
    gain = (gain_ch * spe).astype(np.float32)
    valid = (ch >= 0) & (rng.random(n) > 0.02)
    return dict(t=t, ch=ch, gain=gain, is_dpe=dpe, valid=valid)


def truth_case(name, detector='XENONnT', seed=2026101714):
    """(params, const, ph, row_edges) of case ``name``: the photons after
    the PMT photon pass (t, ch, gain, is_dpe, valid, truth_row) as CPU
    tensors, and the (R + 1,) int64 row edges."""
    params, const = setup_of(detector)
    C = int(params.gains.shape[0])
    gain_ch = float(params.chan_pack[0, 0])
    rng = np.random.default_rng(seed + TRUTH_CASES.index(name))
    if name == 'bench rows':
        lengths = [0, 5, 1, 14, 14, 13, 176, 180, 0, 3076, 2900, 14, 1]
        ph = _rows(rng, lengths, 1_000, 1500, C, gain_ch)
        lo = int(np.sum(lengths[:1]))
        ph['valid'][lo:lo + 5] = False            # a row without a valid one
        ph['valid'][lo + 5] = True                # the one-photon row
        ph['ch'][lo + 5] = max(int(ph['ch'][lo + 5]), 0)
    elif name == 'one row of 10^6':
        lengths = [3000, 1_000_000, 14, 0, 2500]
        ph = _rows(rng, lengths, 50_000, 3000, C, gain_ch)
    elif name == 'late times':
        lengths = [14, 176, 3076, 1, 300]
        ph = _rows(rng, lengths, 2 ** 30 - 20_000_000, 1500, C, gain_ch)
    elif name == 'moment range':
        # the wide row last: the twin's global float64 cumsum of squares
        # (~2^74 after it) would lose the rows after it
        lengths = [176, 14, 4097]
        ph = _rows(rng, lengths, 1_000, 1500, C, gain_ch)
        lo, k = lengths[0] + lengths[1], lengths[2]
        ph['t'][lo:lo + k] = rng.integers(-2 ** 30, 2 ** 30, k)
        ph['t'][lo] = -2 ** 30                   # span 2^31 - 1 or more
        ph['t'][lo + 1] = 2 ** 30 + 5
        ph['valid'][lo:lo + 2] = True
        ph['ch'][lo:lo + 2] = 3
    else:                                        # 'area range'
        lengths = [176, 300, 300, 14]
        ph = _rows(rng, lengths, 1_000, 1500, C, gain_ch)
        a = lengths[0]
        ph['gain'][a + 7] = np.float32(gain_ch * 1e-4)       # a term < 2^-9
        ph['valid'][a + 7] = True
        ph['ch'][a + 7] = 11
        b = a + lengths[1]
        ph['gain'][b + 3] = np.float32(gain_ch * 2.0 ** 23)  # 300 x 2^23
        ph['valid'][b + 3] = True
        ph['ch'][b + 3] = 12
    R = len(lengths)
    ph['truth_row'] = np.repeat(np.arange(R), lengths).astype(np.int64)
    edges = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return (params, const, {k: torch.as_tensor(v) for k, v in ph.items()},
            torch.as_tensor(edges))


# ---------------------------------------------------------------------------
# the numpy emulation of the kernels' arithmetic

U64 = np.uint64


def photon_terms(params, const, ph):
    """Per photon, numpy: the valid mask, the clamped channel, the PE
    count (1 or 2), the trigger and bottom flags (valid only) and the
    float32 raw-area term (0 where invalid), from the twins'
    ``_truth_terms`` (the kernels' per-photon arithmetic is bitwise the
    twins', tests/test_torch_cuda.py)."""
    terms, chc, bot = pmt._truth_terms(params, const, ph)
    v = ph['valid'].numpy()
    return dict(valid=v, ch=chc.numpy(), pe=terms[1].numpy().astype(np.int64),
                above=terms[2].numpy() > 0, bottom=bot.numpy(),
                x=terms[4].numpy().astype(np.float32))


def area_fixed(x):
    """float32 x as the kernel's int64 multiple of 2^-AREA_SCALE (rounded
    to nearest, as __float2ll_rn; out-of-range values clipped: their rows
    fail the guard and their fixed-point sums are not used)."""
    y = np.rint(x.astype(np.float64) * 2.0 ** pmt.AREA_SCALE)
    y = np.where(np.isfinite(y), np.clip(y, -2.0 ** 62, 2.0 ** 62), 0.0)
    return y.astype(np.int64).view(U64)


def areas_ok(cnt, xlo, xhi):
    """The kernel's fixed-point guard per row (xhi 0: every term 0)."""
    with np.errstate(invalid='ignore', over='ignore'):
        return (xhi == 0) | ((xlo >= 2.0 ** (23 - pmt.AREA_SCALE))
                             & (cnt.astype(np.float64) * xhi
                                <= 2.0 ** (62 - pmt.AREA_SCALE)))


def moments_ok(cnt, mn, mx):
    """The kernel's moment guard per row: count x span^2 < 2^62, exact."""
    return np.array([c == 0 or int(c) * (int(b) - int(a)) ** 2 < 2 ** 62
                     for c, a, b in zip(cnt, mn, mx)], dtype=bool)


def _seq(x):
    """The sequential float64 sum of ``x`` from 0.0 (the kernel's adds in
    order)."""
    return float(np.cumsum(x, dtype=np.float64)[-1]) if len(x) else 0.0


def _lane_butterfly(vals):
    """Lane 0's value of the kernel's xor butterfly over 32 lane values."""
    v = np.asarray(vals, dtype=np.float64)
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(WARP) ^ o]
    return float(v[0])


def row_second_pass(t, valid, x_terms, lo, hi, base):
    """The row kernel's float64 second pass over [lo, hi): each lane's
    sums over photons lo + lane + 32 i in order, then lane 0's butterfly;
    the moments of the int32 differences t - base and the four areas."""
    idx = np.arange(lo, hi)
    out = []
    c = (t[lo:hi].astype(np.int64) - base).astype(np.int32).astype(np.float64)
    series = [c, c * c] + ([] if x_terms is None else
                           [w[lo:hi] for w in x_terms])
    for s in series:
        lanes = []
        for lane in range(WARP):
            j = idx[lane::WARP] - lo
            j = j[valid[lo:hi][j]]
            lanes.append(_seq(s[j]))
        out.append(_lane_butterfly(lanes))
    return out


def emulate_row_truth(t, valid, row_edges, terms=None, wc=None):
    """The row kernel's outputs from numpy inputs: ``t`` int32, ``valid``
    bool (None: every element), ``row_edges`` int64, ``terms`` from
    :func:`photon_terms` (None: time statistics only) and the chunk size
    ``wc`` (default the chunk of ``row_truth_layout(n, R)``).  Returns (outputs as the
    wrapper's dict of numpy arrays, (moments, areas) bool rows of the
    second pass)."""
    n = len(t)
    e = np.minimum(row_edges, n)
    R = len(e) - 1
    wc = pmt.row_truth_layout(n, R)[1] if wc is None else wc
    v = np.ones(n, bool) if valid is None else valid
    # pieces: a row longer than a chunk cut after its first chunk and at
    # every tile edge past it, the others whole (empty pieces dropped)
    grid = np.arange(0, n + 1, wc)
    cuts = [e]
    for r in np.flatnonzero(np.diff(e) > wc):
        first = e[r] + wc
        cuts.append([first])
        cuts.append(grid[(grid > first) & (grid < e[r + 1])])
    cuts = np.unique(np.concatenate(cuts))
    cuts = cuts[(cuts >= e[0]) & (cuts <= e[-1])]
    starts = cuts[:-1]
    piece_row = np.searchsorted(e, starts, side='right') - 1
    tt = t.astype(np.int64)
    cols = dict(cnt=v.astype(np.int64), s1=np.where(v, tt, 0),
                s2=np.where(v, tt * tt, 0))
    if terms is not None:
        xf = area_fixed(terms['x']).view(np.int64)
        pe, ab, bt = terms['pe'], terms['above'], terms['bottom']
        for pre, m in (('', v), ('b', v & bt)):
            cols[pre + 'c0'] = m.astype(np.int64)
            cols[pre + 'c1'] = np.where(m, pe, 0)
            cols[pre + 'c2'] = (m & ab).astype(np.int64)
            cols[pre + 'c3'] = np.where(m & ab, pe, 0)
            cols[pre + 'a0'] = np.where(m, xf, 0)
            cols[pre + 'a1'] = np.where(m & ab, xf, 0)
    tot = {}
    for k, col in cols.items():
        # each piece's sum in wrapping uint64 (a warp's registers), then
        # each row's pieces added in wrapping uint64 (the accumulator)
        row = np.zeros(R, U64)
        if len(starts):
            piece = np.add.reduceat(col[:int(e[-1])].view(U64), starts)
            np.add.at(row, piece_row, piece)
        tot[k] = row
    big = 2 ** 31 - 1
    mn = np.full(R, big, np.int64)
    mx = np.full(R, -big, np.int64)
    rows_of = np.repeat(np.arange(R), np.diff(e))
    seg = slice(int(e[0]), int(e[-1]))
    sel = v[seg]
    np.minimum.at(mn, rows_of[sel], tt[seg][sel])
    np.maximum.at(mx, rows_of[sel], tt[seg][sel])
    cnt = tot['cnt'].astype(np.int64)
    # min-centred moments, modulo 2^64, then once to float64
    m = mn.astype(np.int64).view(U64)
    with np.errstate(over='ignore'):
        c1 = tot['s1'] - cnt.view(U64) * m
        c2 = tot['s2'] - U64(2) * m * tot['s1'] + cnt.view(U64) * (m * m)
    d1 = np.where(cnt > 0, c1.astype(np.float64), 0.0)
    d2 = np.where(cnt > 0, c2.astype(np.float64), 0.0)
    ok_m = moments_ok(cnt, mn, mx)
    out_areas = []
    ok_a = np.ones(R, bool)
    x_terms = None
    if terms is not None:
        ax = np.abs(terms['x']).astype(np.float64)
        nz = v & (ax != 0)
        xlo = np.full(R, np.inf)
        xhi = np.zeros(R)
        np.minimum.at(xlo, rows_of[nz[seg]], ax[seg][nz[seg]])
        np.maximum.at(xhi, rows_of[nz[seg]], ax[seg][nz[seg]])
        ok_a = areas_ok(cnt, xlo, xhi) & np.isfinite(xhi)
        for k in ('a0', 'a1', 'ba0', 'ba1'):
            out_areas.append(tot[k].view(np.int64).astype(np.float64)
                             * 2.0 ** -pmt.AREA_SCALE)
        x = terms['x'].astype(np.float64)
        x_terms = [np.where(v, x, 0.0), np.where(v & ab, x, 0.0),
                   np.where(v & bt, x, 0.0), np.where(v & bt & ab, x, 0.0)]
    for r in np.flatnonzero(~ok_m | ~ok_a):
        got = row_second_pass(t, v, x_terms, int(e[r]), int(e[r + 1]),
                              int(mn[r]) if cnt[r] else big)
        if not ok_m[r]:
            d1[r], d2[r] = got[0], got[1]
        if terms is not None and not ok_a[r]:
            for k in range(4):
                out_areas[k][r] = got[2 + k]
    cntf = np.where(cnt > 1, cnt, 1).astype(np.float64)
    mean = d1 / cntf
    var = d2 / cntf - mean * mean
    out = dict(count=cnt, t_min=np.where(cnt > 0, mn, big).astype(np.int32),
               t_max=np.where(cnt > 0, mx, -big).astype(np.int32),
               t_mean_offset=mean, t_sigma=np.sqrt(np.maximum(var, 0.0)))
    if terms is not None:
        for pre, a in (('', out_areas[:2]), ('b', out_areas[2:])):
            suf = '' if not pre else '_bottom'
            for k, name in enumerate(('n_photon', 'n_pe', 'n_photon_trigger',
                                      'n_pe_trigger')):
                out[name + suf] = tot[pre + f'c{k}'].astype(np.float64)
            out['raw_area' + suf] = a[0]
            out['raw_area_trigger' + suf] = a[1]
    return out, (~ok_m, ~ok_a if terms is not None else np.zeros(R, bool))


def emulate_per_pmt(terms, row_edges, C):
    """The per-PMT kernel's outputs, numpy: int32 counts and the float64
    areas as exact fixed-point sums, or in photon order per channel for a
    row outside the fixed-point range; returns (dict of (R, C) arrays,
    (R,) bool rows of the second pass)."""
    n = len(terms['x'])
    e = np.minimum(row_edges, n)
    R = len(e) - 1
    v = terms['valid']
    rows = np.repeat(np.arange(R), np.diff(e))
    seg = slice(int(e[0]), int(e[-1]))
    sel = v[seg]
    r, c = rows[sel], terms['ch'][seg][sel]
    pe, ab = terms['pe'][seg][sel], terms['above'][seg][sel]
    x = terms['x'][seg][sel]
    xf = area_fixed(x).view(np.int64)
    counts = np.zeros((4, R, C), np.int64)
    fixed = np.zeros((2, R, C), np.int64)
    np.add.at(counts[0], (r, c), 1)
    np.add.at(counts[1], (r, c), pe)
    np.add.at(counts[2], (r, c), ab.astype(np.int64))
    np.add.at(counts[3], (r, c), np.where(ab, pe, 0))
    with np.errstate(over='ignore'):
        np.add.at(fixed[0], (r, c), xf)
        np.add.at(fixed[1], (r, c), np.where(ab, xf, 0))
    areas = fixed.astype(np.float64) * 2.0 ** -pmt.AREA_SCALE
    ax = np.abs(x).astype(np.float64)
    nz = ax != 0
    xlo = np.full(R, np.inf)
    xhi = np.zeros(R)
    np.minimum.at(xlo, r[nz], ax[nz])
    np.maximum.at(xhi, r[nz], ax[nz])
    cnt = np.bincount(r, minlength=R)
    bad = ~(areas_ok(cnt, xlo, xhi) & np.isfinite(xhi))
    for row in np.flatnonzero(bad):
        m = r == row
        for k, w in enumerate((x[m], np.where(ab[m], x[m], 0))):
            a = np.zeros(C)
            np.add.at(a, c[m], w.astype(np.float64))     # photon order
            areas[k, row] = a
    names = pmt.PER_PMT_SUMS
    out = {names[k]: counts[k].astype(np.int32) for k in range(4)}
    out.update({names[4 + k]: areas[k] for k in range(2)})
    return out, bad


# ---------------------------------------------------------------------------
# exactness of the twins' own float64 sums


def moments_exact(t, valid, row_edges, cnt, mn):
    """Whether the twin's float64 cumsums of the min-centred times and
    their squares are exact: every partial sum below 2^53."""
    e = row_edges
    v = np.ones(len(t), bool) if valid is None else valid
    seg = slice(int(e[0]), int(e[-1]))
    rows = np.repeat(np.arange(len(e) - 1), np.diff(e))
    base = np.where(cnt > 0, mn, 0)[rows]
    c = np.where(v[seg], t[seg].astype(np.int64) - base, 0).astype(
        np.float64)
    # float64 sums within a factor 2 of 2^53 bound the exact ones below it
    return np.abs(c).sum() < 2.0 ** 52 and (c * c).sum() < 2.0 ** 52


def areas_exact(x, valid):
    """Whether every float64 partial sum of the float32 terms ``x`` (the
    valid ones, in any order) is exact: they are all multiples of the
    smallest last bit among them, and their magnitudes sum below 2^53 of
    it."""
    a = np.abs(x[valid & (x != 0)]).astype(np.float64)
    if not len(a):
        return True
    if not np.all(np.isfinite(a)):
        return False
    ulp = np.spacing(a.astype(np.float32)).astype(np.float64).min()
    return a.sum() < 2.0 ** 53 * ulp


# ---------------------------------------------------------------------------
# tests


def _np(out):
    return {k: v.numpy() for k, v in out.items()}


def assert_same(got, want, rtol_keys=()):
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        if k in rtol_keys:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=k)
        else:
            assert np.array_equal(a.view(np.uint8), b.astype(a.dtype).view(
                np.uint8)), k


FLOAT_KEYS = ('raw_area', 'raw_area_trigger', 'raw_area_bottom',
              'raw_area_trigger_bottom', 't_mean_offset', 't_sigma')


@pytest.mark.parametrize('name', TRUTH_CASES)
def test_row_truth_emulation_matches_twins(name):
    """The row kernel's arithmetic against pulse_truth_ref and
    photon_time_stats_ref: counts bitwise; moments and areas bitwise
    where the twins' float64 sums are exact, else within rtol 1e-12."""
    params, const, ph, edges = truth_case(name)
    terms = photon_terms(params, const, ph)
    R = edges.shape[0] - 1
    want = pmt.pulse_truth_ref(params, const, ph, edges)
    want.update(pmt.photon_time_stats_ref(ph['t'], ph['valid'],
                                          ph['truth_row'], R, edges))
    want = _np(want)
    got, (sec_m, sec_a) = emulate_row_truth(
        ph['t'].numpy(), ph['valid'].numpy(), edges.numpy(), terms)
    assert got['count'].dtype == want['count'].dtype
    loose = []
    if not moments_exact(ph['t'].numpy(), ph['valid'].numpy(),
                         edges.numpy(), want['count'], want['t_min']):
        loose += ['t_mean_offset', 't_sigma']
    if not areas_exact(terms['x'], terms['valid']) or sec_a.any():
        loose += [k for k in FLOAT_KEYS if k.startswith('raw')]
    assert_same(got, want, loose)
    assert (int(sec_m.sum()), int(sec_a.sum())) == SECOND_PASS[name]
    if name in ('bench rows', 'one row of 10^6', 'late times'):
        assert not loose               # the twins are exact: bitwise


@pytest.mark.parametrize('name', TRUTH_CASES)
def test_time_stats_emulation_matches_twin(name):
    """The electron-time call (no channels, every element valid) against
    photon_time_stats_ref."""
    _params, _const, ph, edges = truth_case(name)
    R = edges.shape[0] - 1
    want = _np(pmt.photon_time_stats_ref(ph['t'], None, ph['truth_row'], R,
                                         edges))
    got, (sec_m, _) = emulate_row_truth(ph['t'].numpy(), None,
                                        edges.numpy())
    exact = moments_exact(ph['t'].numpy(), None, edges.numpy(),
                          want['count'], want['t_min'])
    assert_same(got, want, () if exact else ('t_mean_offset', 't_sigma'))
    assert int(sec_m.sum()) == SECOND_PASS[name][0]


@pytest.mark.parametrize('detector', ['XENONnT', 'XENON1T'])
@pytest.mark.parametrize('name', TRUTH_CASES)
def test_per_pmt_emulation_matches_twin(name, detector):
    """The per-PMT kernel's arithmetic against pulse_truth_per_pmt_ref on
    494 and 248 channels: counts bitwise, areas bitwise where the twin's
    sums are exact (rtol 1e-12 on the second-pass rows)."""
    params, const, ph, edges = truth_case(name, detector)
    C = int(params.gains.shape[0])
    terms = photon_terms(params, const, ph)
    want = _np(pmt.pulse_truth_per_pmt_ref(params, const, ph, edges))
    got, bad = emulate_per_pmt(terms, edges.numpy(), C)
    assert int(bad.sum()) == SECOND_PASS[name][1]
    exact = areas_exact(terms['x'], terms['valid']) and not bad.any()
    assert_same(got, want, () if exact else pmt.PER_PMT_SUMS[4:])
    if not exact:
        # the second pass adds in the twin's order: its rows are bitwise
        for k in pmt.PER_PMT_SUMS[4:]:
            assert np.array_equal(got[k][bad], want[k][bad])


@pytest.mark.parametrize('name', TRUTH_CASES)
def test_second_pass_rows_match_guard_twin(name):
    """row_truth_second_pass_ref flags exactly the rows the emulation sends
    to the second pass, with and without channels."""
    params, const, ph, edges = truth_case(name)
    terms = photon_terms(params, const, ph)
    mom, area = pmt.row_truth_second_pass_ref(params, const, ph['t'],
                                              ph['valid'], edges, ph=ph)
    _out, (sec_m, sec_a) = emulate_row_truth(
        ph['t'].numpy(), ph['valid'].numpy(), edges.numpy(), terms)
    assert np.array_equal(mom.numpy(), sec_m)
    assert np.array_equal(area.numpy(), sec_a)
    mom, area = pmt.row_truth_second_pass_ref(None, None, ph['t'], None,
                                              edges)
    _out, (sec_m, _) = emulate_row_truth(ph['t'].numpy(), None,
                                         edges.numpy())
    assert np.array_equal(mom.numpy(), sec_m) and not area.any()


@pytest.mark.parametrize('wc', [32, 64, 1024, 8192])
def test_row_emulation_independent_of_chunk(wc):
    """The integer sums do not depend on where the rows are cut: every
    chunk size gives the same bits (the 10^6 row with rows of 14-3,000
    beside it)."""
    params, const, ph, edges = truth_case('one row of 10^6')
    terms = photon_terms(params, const, ph)
    args = (ph['t'].numpy(), ph['valid'].numpy(), edges.numpy(), terms)
    ref, _ = emulate_row_truth(*args)
    got, _ = emulate_row_truth(*args, wc=wc)
    assert_same(got, ref)


def test_row_truth_layout_rule():
    """The row kernel's layout: a block a row's first 8,192 elements where
    the mean row holds 512 or more (the bench S2 photons, 1.57 M in 512
    rows), else a warp a row's first chunk: a power of two from 32 to
    1,024, no shorter than twice the mean row and giving at most 2,048
    tiles where the batch allows (the S1 photons and S2 electrons, 6,966
    and 90,194 in 512 rows)."""
    assert [pmt.row_truth_layout(n, 512) for n in
            (0, 6966, 8192, 8193, 90_194, 262_143, 262_144, 1_574_874)] == \
        [(False, 32), (False, 32), (False, 32), (False, 64), (False, 512),
         (False, 1024), (True, 8192), (True, 8192)]
    assert [pmt.row_truth_layout(n, 10 ** 6) for n in
            (65_536, 65_537, 10 ** 9)] == [(False, 32), (False, 64),
                                           (True, 8192)]


def test_moment_sums_wrap_exactly():
    """Sums of t and t^2 modulo 2^64 over pieces, shifted to the row
    minimum, give the exact min-centred moments although the raw sums
    wrap (times near 2^31 in 10^5 photons: sum t^2 ~ 4.6e23)."""
    rng = np.random.default_rng(7)
    t = (2 ** 31 - 1 - rng.integers(0, 5000, 100_000)).astype(np.int32)
    out, (sec, _) = emulate_row_truth(t, None, np.array([0, len(t)]))
    c = t.astype(np.int64) - int(t.min())
    assert not sec.any()
    assert sum(int(a) ** 2 for a in t) >= 2 ** 64
    assert out['t_mean_offset'][0] == float(int(c.sum())) / len(t)
    s2 = float(sum(int(a) * int(a) for a in c))
    m = float(int(c.sum())) / len(t)
    assert out['t_sigma'][0] == np.sqrt(max(s2 / len(t) - m * m, 0.0))


def test_scratch_kept_per_stream():
    """The truth kernels' zeroed scratch is one buffer per (device,
    stream), grown where a call needs more and otherwise reused."""
    a = pmt._scratch(torch.device('cpu'), 101, 10)
    assert a.dtype == torch.int64 and a.numel() >= 10 and not a.any()
    assert pmt._scratch(torch.device('cpu'), 101, 10) is a
    assert pmt._scratch(torch.device('cpu'), 102, 10) is not a
    big = pmt._scratch(torch.device('cpu'), 101, 5000)
    assert big.numel() >= 5000 and not big.any()
    assert pmt._scratch(torch.device('cpu'), 101, 10) is big
    for key in [k for k in pmt._SCRATCH if k[1] in (101, 102)]:
        del pmt._SCRATCH[key]


def test_cpu_paths_check_edges():
    """On the CPU the public functions raise where the rows reach past the
    photons (on the card the kernels clamp them: no read-back)."""
    params, const, ph, edges = truth_case('bench rows')
    bad = edges.clone()
    bad[-1] += 1
    R = edges.shape[0] - 1
    with pytest.raises(ValueError, match='row edges reach past'):
        pmt.photon_time_stats(ph['t'], None, ph['truth_row'], R, bad)
    with pytest.raises(ValueError, match='row edges reach past'):
        pmt.pulse_truth_per_pmt(params, const, ph, bad)
