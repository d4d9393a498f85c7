"""The luminescence tables (``luminescence_tables``, K6) and the
electron-afterpulse photon summaries (``photon_summaries``, K11 summaries)
of wfsim_tpu_torch — on the CPU their plain twins — on the cases to which
their kernels are sensitive: ``csrc/luminescence.cu`` (block-wide float64
scans in chunks, taken where every partial sum of a row is exact in
float64, a sequential pass elsewhere) and ``csrc/pmt_afterpulse.cu``'s
summaries (each instruction's valid photons and offset from one prefix
count of the valid photons over ascending truth rows).

- K6: the twin with an explicit per-instruction gas gap against the float64
  numpy oracle of tests/test_torch_photon_passes.py; the exactness
  predicate (``lumi_sequential_rows_ref``, the rows the kernel integrates
  sequentially) against a numpy mirror in exact integer arithmetic; and a
  numpy emulation of the kernel's order of float64 adds (chunks, warp
  scans, warp totals, the light-weighted sum's butterfly reduction) equal
  to the sequential sums on every row the predicate passes.
- The summaries: the twin against wfsim_tpu's ``photon_summaries`` given
  the same uniforms (its ``jax.random.uniform`` replaced by them, run
  without jit), and against a numpy oracle of the kernel's counts and
  offsets from prefix counts at each row's photon range.

The cases are numpy only, made from a seed (``lumi_case``,
``summary_case``), so that the card's machine, which has no JAX, can
import them for tests/test_torch_cuda.py: JAX is imported inside the
fixture that uses it.

Tolerances: bitwise everywhere (the tables, the cumulative values and
avgt, the counts and candidates); the predicate's rows exactly.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from wfsim_tpu_torch import units
from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models import afterpulse as ap
from wfsim_tpu_torch.models import s2
from wfsim_tpu_torch.models.params import build_constants

# ---------------------------------------------------------------------------
# K6 cases

#: a pressure (bar) whose light-yield offset 0.8 p lies two float32 ulps
#: from E0 / r at r = 0.01996 cm of the default gas gap: the dy there is
#: 3.8e-6, whose products with t_cum have last bits too fine for the
#: light-weighted sum to be exact in every order (chip_smoke.py's
#: LUMI_SEQUENTIAL_BAR is the same value)
SEQUENTIAL_PRESSURE_BAR = 22.70032
LUMI_ROWS = 16
LUMI_CASES = (
    'the default gas gap',
    'gas gaps over the anode gap',
    'an offset crossing zero in the gap',
    'half the gaps the default one, offset crossing zero',
)
#: the rows of each case on the kernel's sequential path: none, all, some
LUMI_SEQUENTIAL = {LUMI_CASES[0]: 'none', LUMI_CASES[1]: 'none',
                   LUMI_CASES[2]: 'all', LUMI_CASES[3]: 'some'}


def lumi_case(name):
    """(const, dG or None, n_inst): the default constants (at
    SEQUENTIAL_PRESSURE_BAR for the last two cases) and float32 gas gaps
    uniform between the wire and the gate (in the last case every other
    row has the default gap instead: the near-zero dy belongs to its
    field, and another gap's field moves it)."""
    const = build_constants(default_config())
    if name in LUMI_CASES[2:]:
        const = dataclasses.replace(
            const, pressure=SEQUENTIAL_PRESSURE_BAR * units.bar)
    if name in LUMI_CASES[::2]:
        return const, None, LUMI_ROWS
    rng = np.random.default_rng(LUMI_CASES.index(name) + 1300)
    dG = rng.uniform(const.anode_wire_radius, const.gate_to_anode_distance,
                     LUMI_ROWS).astype(np.float32)
    if name == LUMI_CASES[3]:
        dG[::2] = const.elr_gas_gap_length
    return const, dG, LUMI_ROWS


def lumi_terms_np(const, n_inst, dG=None):
    """(dt, dy) float32 (n_inst, R): the integration's terms in numpy, the
    twin's float32 steps, 0 outside each instruction's gas gap (the
    constant ``elr_gas_gap_length`` unless ``dG`` is given)."""
    f = np.float32
    number_density_gas = const.pressure / (units.boltzmannConstant
                                           * const.temperature)
    alpha = const.gas_drift_velocity_slope / number_density_gas
    rA, rW = const.anode_field_domination_distance, const.anode_wire_radius
    dG = (np.full(n_inst, f(const.elr_gas_gap_length)) if dG is None
          else np.asarray(dG, f))
    dL = f(const.gate_to_anode_distance) - dG
    VG = f(1) / (f(1) + dL / dG / f(const.lxe_dielectric_constant)) \
        * f(const.anode_voltage)
    E0 = VG / ((dG - f(rA)) / f(rA) + f(np.log(rA / rW)))
    r = np.arange(const.gate_to_anode_distance, rW, -1e-4, dtype=np.float32)
    rr = np.clip(f(1) / r, f(1 / rA), f(1 / rW))
    dt = f(1) / (f(alpha) * E0[:, None] * rr[None, :]) * f(1e-4)
    dy = E0[:, None] * rr[None, :] / f(units.kV / units.cm) \
        - f(0.8 * (const.pressure / units.bar))
    mask = r[None, :] <= dG[:, None]
    return np.where(mask, dt, f(0)), np.where(mask, dy, f(0))


def exact_rows_np(x):
    """Per row of float32 terms, whether every partial sum in any order is
    exact in float64, in exact integer arithmetic: with e the lowest set
    bit's exponent over the row's nonzero terms, sum |x| / 2^e (a Python
    integer) below 2^52, the kernel's test (``csrc/luminescence.cu``)."""
    out = []
    for row in x:
        nz = row[row != 0].astype(np.float64)
        if not np.all(np.isfinite(nz)):
            out.append(False)
            continue
        m, p = np.frexp(nz)
        sig = np.abs((m * 2.0 ** 24).astype(np.int64))   # x = sig 2^(p-24)
        tz = np.log2((sig & -sig).astype(np.float64)).astype(np.int64)
        low = p.astype(np.int64) - 24 + tz       # x = (sig >> tz) 2^low
        e = int(low.min()) if len(nz) else 0
        total = sum((int(s) >> int(z)) << int(q - e)
                    for s, z, q in zip(sig, tz, low))
        out.append(total < 2 ** 52)
    return np.array(out, dtype=bool)


def sequential_rows_np(const, n_inst, dG=None):
    """(n_inst,) bool: the rows whose t, y or light-weighted terms fail
    exact_rows_np, as the kernel decides them."""
    dt, dy = lumi_terms_np(const, n_inst, dG)
    t_cum = np.cumsum(dt.astype(np.float64), axis=1).astype(np.float32)
    return ~(exact_rows_np(dt) & exact_rows_np(dy)
             & exact_rows_np(t_cum * dy))


def kernel_order_np(dt, dy, threads=256):
    """One row's (t_cum, y_cum, avgt) with its float64 adds in the
    kernel's order: a thread's chunk of C (odd) points summed in order,
    an inclusive warp scan of the chunk sums (lane l adds lane l - d's
    value for d = 1, 2, 4, 8, 16), the exclusive prefix (scan - own) plus
    the earlier warps' totals one by one, the chunk walked again from it;
    the light-weighted chunk sums reduced by a butterfly (lane 0's value)
    and the warps' sums added in order."""
    f64 = np.float64
    R = dt.shape[0]
    C = -(-R // threads) | 1
    n_warps = threads // 32
    k0 = np.minimum(np.arange(threads) * C, R)
    k1 = np.minimum(k0 + C, R)

    def chunk_sums(x):
        out = np.zeros(threads)
        for j in range(threads):
            acc = f64(0)
            for v in x[k0[j]:k1[j]]:
                acc = acc + f64(v)
            out[j] = acc
        return out

    def prefixes(s):
        w = s.reshape(n_warps, 32).copy()
        for d in (1, 2, 4, 8, 16):
            w[:, d:] = w[:, d:] + w[:, :-d]
        pre = (w - s.reshape(n_warps, 32)).reshape(-1)
        for j in range(threads):
            for wp in range(j // 32):
                pre[j] = pre[j] + w[wp, 31]
        return pre, w[:, 31]

    pre_t, _ = prefixes(chunk_sums(dt))
    pre_y, tot_y = prefixes(chunk_sums(dy))
    t_cum = np.zeros(R, np.float32)
    y_cum = np.zeros(R, np.float32)
    sn = np.zeros(threads)
    for j in range(threads):
        at, ay, acc = pre_t[j], pre_y[j], f64(0)
        for k in range(k0[j], k1[j]):
            at = at + f64(dt[k])
            ay = ay + f64(dy[k])
            t_cum[k], y_cum[k] = np.float32(at), np.float32(ay)
            acc = acc + f64(t_cum[k] * dy[k])
        sn[j] = acc
    w = sn.reshape(n_warps, 32).copy()
    for d in (16, 8, 4, 2, 1):
        w = w + w[:, np.arange(32) ^ d]
    num = y_total = f64(0)
    for wp in range(n_warps):
        num = num + w[wp, 0]
        y_total = y_total + tot_y[wp]
    avgt = np.float32(num / max(y_total, 1e-30))
    return t_cum, y_cum, avgt


def sequential_np(dt, dy):
    """One row's (t_cum, y_cum, avgt) in the twin's order."""
    t64 = np.cumsum(dt.astype(np.float64))
    y64 = np.cumsum(dy.astype(np.float64))
    t_cum, y_cum = t64.astype(np.float32), y64.astype(np.float32)
    num = np.cumsum((t_cum * dy).astype(np.float64))[-1]
    return t_cum, y_cum, np.float32(num / max(y64[-1], 1e-30))


# ---------------------------------------------------------------------------
# K11 summaries cases

SUMMARY_N, SUMMARY_INST, SUMMARY_K = 30_000, 12, 64
SUMMARY_CASES = (
    'a bench-like set',
    'empty rows',
    'a row of invalid photons only',
    'valid photons at rows past n_inst',
    'one row holding most photons',
    'u at 0 and just below 1',
    'rows ending on tile and word edges',
    'no photon',
)
#: the cases held against wfsim_tpu (its slots clip to an empty array
#: where there is no photon)
JAX_SUMMARY_CASES = SUMMARY_CASES[:7]
#: the row boundaries of the tile-edge case: rows ending on a 32-photon
#: word or a 1,024-photon tile
TILE_EDGES = (0, 32, 1024, 1056, 4096, 8192, 8224, 16352, 16384)


def summary_case(name):
    """(photons as numpy arrays: t int32, valid bool, truth_row int64
    ascending; u (n_inst, K) float32; n_inst)."""
    rng = np.random.default_rng(SUMMARY_CASES.index(name) + 1400)
    n, n_inst = SUMMARY_N, SUMMARY_INST
    valid = rng.random(n) < 0.9
    rows = rng.integers(0, n_inst, n)
    if name == 'empty rows':
        rows = rng.choice([1, 2, 5, 6, 7, 9, 10], n)     # 0, 3, 4, 8, 11 empty
    elif name == 'a row of invalid photons only':
        rows = np.sort(rows)
        valid[rows == 4] = False
    elif name == 'valid photons at rows past n_inst':
        rows = rng.integers(0, n_inst + 4, n)
    elif name == 'one row holding most photons':
        rows[: n * 9 // 10] = 5
    elif name == 'rows ending on tile and word edges':
        n = TILE_EDGES[-1]
        rows = np.repeat(np.arange(len(TILE_EDGES) - 1), np.diff(TILE_EDGES))
        valid = rng.random(n) < 0.9
    elif name == 'no photon':
        n = 0
        rows, valid = rows[:0], valid[:0]
    u = rng.random((n_inst, SUMMARY_K), dtype=np.float32)
    if name == 'u at 0 and just below 1':
        u.reshape(-1)[::7] = 0.0
        u.reshape(-1)[3::7] = np.float32(1 - 2 ** -24)
    ph = dict(t=rng.integers(-1000, 3_000_000, n).astype(np.int32),
              valid=valid, truth_row=np.sort(rows).astype(np.int64))
    return ph, u, n_inst


def summaries_oracle(ph, u, n_inst):
    """The kernel's counts and candidates in numpy: F(x), the valid
    photons before photon x; a row's range [rs, re) by searches of the
    ascending rows; count F(re) - F(rs), offset F(rs) - F(rs_0)."""
    F = np.concatenate([[0], np.cumsum(ph['valid'])])
    rs = np.searchsorted(ph['truth_row'], np.arange(n_inst), side='left')
    re = np.searchsorted(ph['truth_row'], np.arange(n_inst) + 1, side='left')
    counts = F[re] - F[rs]
    offsets = F[rs] - F[rs[0]]
    n = len(ph['t'])
    slot = offsets[:, None] + (u * np.maximum(counts, 1)[:, None].astype(
        np.float32)).astype(np.int32)
    return counts.astype(np.int32), ph['t'][np.clip(slot, 0, n - 1)]


def t32(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K6


@pytest.mark.parametrize('name', LUMI_CASES)
def test_lumi_tables_with_gas_gaps_match_float64_oracle(name):
    """The twin with an explicit gas gap per instruction (the constant one
    where the case has none) bitwise the float64 oracle; the constant gap
    given explicitly gives the default call's bits."""
    from .test_torch_photon_passes import tables_oracle
    const, dG, n = lumi_case(name)
    qs = s2._radius_grid(const, torch.device('cpu'))[2].numpy()
    gaps = (np.full(n, np.float32(const.elr_gas_gap_length)) if dG is None
            else dG)
    tab = s2.luminescence_tables(const, n, 'cpu', t32(gaps))
    want = tables_oracle(const, n, qs, gaps)
    np.testing.assert_array_equal(tab.numpy().view(np.int32),
                                  want.view(np.int32))
    if dG is None:
        assert torch.equal(tab, s2.luminescence_tables(const, n, 'cpu'))
    else:
        assert len(np.unique(tab.numpy()[:, -1])) > n // 2   # rows differ


@pytest.mark.parametrize('name', LUMI_CASES)
def test_sequential_rows_match_exact_mirror(name):
    """The rows the kernel integrates sequentially (the twin of its
    count) equal the exact-integer mirror's: none on the default gap and
    on gaps over the whole anode gap, all rows where the offset crosses
    zero inside the default gap, some where the gaps end near the wire."""
    const, dG, n = lumi_case(name)
    rows = s2.lumi_sequential_rows_ref(const, n, 'cpu',
                                       None if dG is None else t32(dG))
    mirror = sequential_rows_np(const, n, dG)
    np.testing.assert_array_equal(rows.numpy(), mirror)
    want = LUMI_SEQUENTIAL[name]
    assert {'none': not mirror.any(), 'all': mirror.all(),
            'some': 0 < mirror.sum() < n}[want], (want, mirror)


def same_bits(a, b):
    return all(np.array_equal(np.atleast_1d(x).view(np.int32),
                              np.atleast_1d(y).view(np.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize('name', LUMI_CASES)
def test_kernel_order_equals_sequential_where_exact(name):
    """The kernel's order of float64 adds gives the sequential sums' bits
    (cumulative t and y, avgt) on every row the predicate passes."""
    const, dG, n = lumi_case(name)
    dt, dy = lumi_terms_np(const, n, dG)
    seq = sequential_rows_np(const, n, dG)
    for i in range(0, n, 3):
        if not seq[i]:
            assert same_bits(kernel_order_np(dt[i], dy[i]),
                             sequential_np(dt[i], dy[i])), i


def test_kernel_order_differs_where_inexact():
    """Terms whose partial sums are not exact (small terms between +1e9
    and -1e9, whose ulp is 2^-23): the predicate fails, and the kernel's
    order gives another last cumulative t than the sequential one, which
    is why such rows take the sequential pass."""
    rng = np.random.default_rng(1301)
    x = rng.random((2, 4883)).astype(np.float32) * np.float32(1e-3)
    x[:, 0], x[:, -1] = 1e9, -1e9
    assert not exact_rows_np(x).any()
    t_k, y_k, _ = kernel_order_np(x[0], x[1])
    t_s, y_s, _ = sequential_np(x[0], x[1])
    assert t_k[-1] != t_s[-1]
    assert np.array_equal(t_k[:-1], t_s[:-1])


# ---------------------------------------------------------------------------
# K11 summaries


@pytest.fixture(scope='module')
def summaries_jax():
    """wfsim_tpu's photon_summaries run without jit, its uniforms replaced
    by the case's."""
    import jax
    import jax.numpy as jnp
    from wfsim_tpu.models import afterpulse as jax_ap

    def run(ph, u, n_inst):
        draw = jax.random.uniform
        jax.random.uniform = lambda key, shape: jnp.asarray(u)
        try:
            with jax.disable_jit():
                counts, tz = jax_ap.photon_summaries(
                    {k: jnp.asarray(v.astype(np.int32) if k == 'truth_row'
                                    else v) for k, v in ph.items()},
                    jax.random.key(0), n_inst=n_inst,
                    k_candidates=u.shape[1])
        finally:
            jax.random.uniform = draw
        return np.asarray(counts), np.asarray(tz)
    return types.SimpleNamespace(run=run)


@pytest.mark.parametrize('name', JAX_SUMMARY_CASES)
def test_photon_summaries_match_jax(summaries_jax, name):
    """Counts and candidates bitwise wfsim_tpu's given the same u."""
    ph, u, n_inst = summary_case(name)
    counts_j, tz_j = summaries_jax.run(ph, u, n_inst)
    counts, tz = ap.photon_summaries({k: t32(v) for k, v in ph.items()},
                                     t32(u), n_inst=n_inst)
    assert counts.dtype == tz.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), counts_j)
    np.testing.assert_array_equal(tz.numpy(), tz_j)
    if name == 'empty rows':
        assert (counts.numpy()[[0, 3, 4, 8, 11]] == 0).all()
    if name == 'a row of invalid photons only':
        assert counts[4] == 0 and (ph['truth_row'] == 4).any()


@pytest.mark.parametrize('name', SUMMARY_CASES)
def test_summaries_from_prefix_counts(name):
    """The kernel's formula (counts and offsets from the valid photons
    before each row's range ends) gives the twin's counts and candidates,
    valid photons past n_inst included."""
    ph, u, n_inst = summary_case(name)
    counts, tz = ap.photon_summaries({k: t32(v) for k, v in ph.items()},
                                     t32(u), n_inst=n_inst)
    if name == 'no photon':
        assert not counts.any() and not tz.any()
        return
    c_o, tz_o = summaries_oracle(ph, u, n_inst)
    np.testing.assert_array_equal(counts.numpy(), c_o)
    np.testing.assert_array_equal(tz.numpy(), tz_o)
    if name == 'valid photons at rows past n_inst':
        assert counts.sum() < ph['valid'].sum()
