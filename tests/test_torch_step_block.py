"""K14, the channel block of the multi-device step
(``csrc/superpose_adc.cu wfsim_superpose_block``), on the CPU: the twin
``superpose_block_ref`` against wfsim_tpu on skewed blocks, and a numpy
emulation of the kernel's decomposition against the twin.

The emulation follows the kernel: a warp a tile of 1,024 samples of a
row, a row's tiles cut from its first 16-byte boundary in the int32 grid
(its origin, 0 to -3 samples, from the grid's address and the row
length), the whole row scanned in row order with the kernel's hit test,
taps added photon by photon in float32, ``-rint(acc * c2a)`` stored where
the tile lies inside the row, tiles without a hit stored as zeros, and
the bottom-array rows' non-zero samples added into the block's sum row
in a shuffled order (the atomics).  tests/test_torch_cuda.py holds the
card's kernel to the twin.

Tolerances: the emulation is held to the twin bitwise, and so is the twin
to wfsim_tpu where a row's photons are spread.  wfsim_tpu sums per
histogram bin and then contracts, so an ADC value within the float32
drift of a .5 tie may round the other way: in the burst case (10^4 adds
a sample) such samples may differ by one count, and each must lie within
that drift of a tie measured against a float64 ``scatter_spe`` (F4).
Each wfsim_tpu shape compiles once per file (a module fixture).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from wfsim_tpu.ops.waveform import photons_to_waveform as jax_waveform

from wfsim_tpu_torch.config import default_config
from wfsim_tpu_torch.models.params import build_constants
from wfsim_tpu_torch.ops.waveform import (make_templates,
                                          photons_to_waveform_ref,
                                          superpose_block,
                                          superpose_block_ref)
from wfsim_tpu_torch.parallel.sharding import block_photons

from .reference_semantics import scatter_spe

#: photons of every case, padded with invalid ones (one compile a shape)
CAP = 40_000
#: the kernel's samples a tile (a warp's)
SPAN = 1024

#: name: (channel shards, block, T, skewed channel, its photons, burst);
#: 4 shards of 124 channels leave rows 494 and 495 of block 3 past the
#: TPC; T not a multiple of 1,024 (nor of 4 where it is 1,025); burst:
#: the skewed channel's photons in one 300 ns S2-like pulse, else spread
#: over the grid
SKEW_CASES = {
    'spread_row_padding': (4, 3, 1500, 400, 20_000, False),
    'burst_row_padding': (4, 3, 1500, 493, 20_000, True),
    'spread_row_whole': (1, 0, 1025, 300, 25_000, False),
}


@pytest.fixture(scope='module')
def setup():
    c = default_config()
    const = build_constants(c)
    templates = make_templates(c['pe_pulse_ts'], c['pe_pulse_ys'])
    return c, const, templates


@pytest.fixture(scope='module')
def jax_block(setup):
    """wfsim_tpu's channel block (sharding.py:101-117): ``get(C_loc, T)``
    is its jitted function of (t, ch_loc, gain, valid, bottom), compiled
    once a shape."""
    _c, const, templates = setup
    fns = {}

    def get(C_loc, T):
        if (C_loc, T) not in fns:
            def f(t, ch_loc, gain, valid, bottom):
                W = jax_waveform(t, ch_loc, gain, valid, 0,
                                 jnp.asarray(templates), n_channels=C_loc,
                                 n_samples=T,
                                 sample_duration=const.sample_duration)
                adc = (-jnp.round(W * const.current_2_adc)).astype(jnp.int32)
                return adc, jnp.sum(jnp.where(bottom[:, None], adc, 0),
                                    axis=0)
            fns[C_loc, T] = jax.jit(f)
        return fns[C_loc, T]
    return get


def skew_case(name, seed=5):
    """(t, ch, gain, valid, layout) of a SKEW_CASES case, CAP photons:
    ~6,000 background photons over every channel (some invalid, some
    without a channel, some before or past the grid), the skewed channel's
    photons, invalid padding."""
    n_sh, block, T, ch_big, n_big, burst = SKEW_CASES[name]
    rng = np.random.default_rng(seed + len(name))
    n_bg = 6_000
    t = rng.integers(-2_000, T * 10 + 2_000, CAP).astype(np.int32)
    ch = rng.integers(0, 494, CAP).astype(np.int32)
    ch[rng.random(CAP) < 0.01] = -1
    gain = (2e6 * np.clip(rng.normal(1.0, 0.4, CAP), 0.05, None)).astype(
        np.float32)
    valid = rng.random(CAP) < 0.98
    big = slice(n_bg, n_bg + n_big)
    ch[big] = ch_big
    valid[big] = True
    if burst:
        t[big] = (T * 5 + rng.exponential(60.0, n_big)).astype(np.int32)
    else:
        t[big] = rng.integers(0, T * 10, n_big)
    valid[n_bg + n_big:] = False
    return t, ch, gain, valid, (n_sh, block, T)


def block_args(setup, t, ch, gain, valid, n_sh, block, T):
    """The torch inputs and keywords of one channel block."""
    _c, const, templates = setup
    C = const.n_tpc_pmts
    C_loc = -(-C // n_sh)
    ph = {k: torch.from_numpy(v) for k, v in
          dict(t=t, ch=ch, gain=gain, valid=valid).items()}
    bp = block_photons(ph, torch.zeros(len(t), dtype=torch.int64),
                       n_blocks=1, ch_block=block * C_loc, n_channels=C_loc,
                       n_samples=T, sample_duration=const.sample_duration)
    args = (bp['t'], bp['gain'], bp['row_ptr'], torch.from_numpy(templates))
    kw = dict(n_channels=C_loc, ch_block=block * C_loc,
              n_top=const.n_top_pmts, n_tpc=C,
              current_2_adc=const.current_2_adc, n_samples=T)
    return args, kw


@pytest.mark.parametrize('name', sorted(SKEW_CASES))
def test_block_twin_matches_jax_on_skewed_blocks(setup, jax_block, name):
    """One row of 20,000-25,000 photons (spread over the grid or in one
    pulse), padding rows past the TPC, T not a multiple of 1,024: the
    twin's ADC and sum row bitwise wfsim_tpu's where the row is spread;
    in the pulse, bitwise but at samples within the float32 drift of a .5
    tie, each one count off (ROADMAP F4)."""
    c, const, templates = setup
    t, ch, gain, valid, (n_sh, block, T) = skew_case(name)
    C = const.n_tpc_pmts
    C_loc = -(-C // n_sh)
    ch_block = block * C_loc
    ch_loc = ch - ch_block
    in_block = (ch_loc >= 0) & (ch_loc < C_loc)
    ch_ids = ch_block + np.arange(C_loc)
    bottom = (ch_ids >= const.n_top_pmts) & (ch_ids < C)
    adc_j, sum_j = (np.asarray(x) for x in jax_block(C_loc, T)(
        jnp.asarray(t), jnp.asarray(np.where(in_block, ch_loc, 0)),
        jnp.asarray(gain), jnp.asarray(valid & in_block),
        jnp.asarray(bottom)))

    args, kw = block_args(setup, t, ch, gain, valid, n_sh, block, T)
    adc, sums = (x.numpy() for x in superpose_block(*args, **kw))
    burst = SKEW_CASES[name][5]
    bad = np.argwhere(adc != adc_j)
    if not burst:
        assert len(bad) == 0, f'{len(bad)} samples differ'
        np.testing.assert_array_equal(sums[0], sum_j)
    else:
        # ~10^4 sequential float32 adds a sample at ~2 x 10^5 counts: the
        # port's photon-by-photon sums drift up to 3.0e-6 of the value
        # from the exact one (wfsim_tpu's per-bin sums 2.5e-7), so a
        # sample whose exact value lies that close to a .5 tie may round
        # the other way, by one count, and the sum row with it
        keep = valid & in_block & (t >= 0)
        x = scatter_spe(t[keep], ch_loc[keep], gain[keep], 0, C_loc, T,
                        templates, const.sample_duration) * c['current_2_adc']
        w32 = photons_to_waveform_ref(*args, n_samples=T).numpy() * \
            np.float32(const.current_2_adc)
        assert np.all(np.abs(w32 - x) <= 4e-6 * np.abs(x) + 1e-3)
        d = adc[tuple(bad.T)] - adc_j[tuple(bad.T)]
        xb = x[tuple(bad.T)]
        assert np.all(np.abs(d) == 1)
        assert np.all(np.abs(np.abs(xb - np.floor(xb)) - 0.5)
                      <= 4e-6 * np.abs(xb) + 1e-4), xb
        assert set(bad[:, 0]) <= {SKEW_CASES[name][3] - ch_block}
        d_rows = np.zeros_like(adc)
        d_rows[tuple(bad.T)] = d
        np.testing.assert_array_equal(
            sums[0] - sum_j, np.where(bottom[:, None], d_rows, 0).sum(0))
    lit = np.count_nonzero(adc[SKEW_CASES[name][3] - ch_block])
    assert lit > (20 if SKEW_CASES[name][5] else T // 2)
    if C_loc * n_sh > C and block == n_sh - 1:
        assert not adc[C - ch_block:].any()       # the padding rows


# ---------------------------------------------------------------------------
# the kernel's decomposition in numpy


def emulate_block(t, gain, row_ptr, templates, *, n_channels, ch_block,
                  n_top, n_tpc, current_2_adc, n_samples, base_word=0,
                  seed=0):
    """(adc, sums, writes, stats) as the kernel computes them (see the
    module docstring); ``base_word`` is the grid's address in 4-byte words
    modulo 4 (0: 16-byte aligned); ``writes`` counts the stores of each
    sample; ``stats``: tiles, tiles with a hit, scan steps."""
    t, gain, row_ptr = (np.asarray(x) for x in (t, gain, row_ptr))
    templates = np.asarray(templates, np.float32)
    dt, L = templates.shape
    T = n_samples
    n_rows = len(row_ptr) - 1
    B = n_rows // n_channels
    c2a = np.float32(current_2_adc)
    aligned = T % 4 == 0 and base_word == 0
    n_seg = (T + (0 if aligned else 3) + SPAN - 1) // SPAN
    adc = np.full((n_rows, T), -7, np.int32)
    writes = np.zeros((n_rows, T), np.int32)
    adds = []                                # (block, sample, value)
    stats = dict(tiles=0, hit_tiles=0, steps=0)
    for row in range(n_rows):
        origin = -((base_word + row * T) % 4)
        p0, p1 = int(row_ptr[row]), int(row_ptr[row + 1])
        tt = t[p0:p1].astype(np.int64)
        s, r = tt // dt, tt % dt
        g = gain[p0:p1]
        b, c = divmod(row, n_channels)
        ch = ch_block + c
        for seg in range(n_seg):
            lo = origin + seg * SPAN
            if lo >= T:
                continue
            hi = min(lo + SPAN, T)
            stats['tiles'] += 1
            stats['steps'] += -(-(p1 - p0) // 128)
            hit = (s + L > lo) & (s < hi)
            acc = np.zeros(SPAN, np.float32)
            for p in np.flatnonzero(hit):    # row order
                u = s[p] + np.arange(L)
                ok = (u >= lo) & (u < hi)
                prod = g[p] * templates[r[p], np.flatnonzero(ok)]
                acc[u[ok] - lo] = acc[u[ok] - lo] + prod
            stats['hit_tiles'] += bool(hit.any())
            if not hit.any():
                assert not acc.any()         # zeros, the tile untouched
            v = (-np.rint(acc * c2a)).astype(np.int32)
            u = np.arange(lo, lo + SPAN)
            keep = (u >= 0) & (u < hi)
            adc[row, u[keep]] = v[keep]
            writes[row, u[keep]] += 1
            if hit.any() and n_top <= ch < n_tpc:
                nz = keep & (v != 0)
                adds += [(b, int(x), int(y)) for x, y in zip(u[nz], v[nz])]
    sums = np.zeros((B, T), np.int64)
    for i in np.random.default_rng(seed).permutation(len(adds)):
        b, u, v = adds[i]
        sums[b, u] += v
    sums = ((sums + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    return adc, sums, writes, stats


@pytest.mark.parametrize('name', sorted(SKEW_CASES))
@pytest.mark.parametrize('base_word', [0, 1, 2, 3])
def test_block_emulation_matches_twin(setup, name, base_word):
    """The kernel's tiles cover every sample of every row once (each row
    cut from its 16-byte boundary, the grid aligned or not), tiles without
    a hit are zeros, and the taps, epilogue and shuffled sum-row atomics
    give the twin's bits."""
    t, ch, gain, valid, layout = skew_case(name)
    args, kw = block_args(setup, t, ch, gain, valid, *layout)
    adc_r, sums_r = (x.numpy() for x in superpose_block_ref(*args, **kw))
    adc, sums, writes, stats = emulate_block(*args, **kw,
                                             base_word=base_word,
                                             seed=base_word)
    assert (writes == 1).all()
    np.testing.assert_array_equal(adc, adc_r)
    np.testing.assert_array_equal(sums, sums_r)
    assert 0 < stats['hit_tiles'] < stats['tiles']


@pytest.mark.parametrize('T', [1, 3, 1000, 1024, 1025, 4099])
@pytest.mark.parametrize('base_word', [0, 2])
def test_block_tiles_cover_rows(setup, T, base_word):
    """Grids of 1 to 4,099 samples, aligned or not, with rows of many
    photons, one photon, none, and photons starting past the grid: the
    tiles cover each sample once and the result is the twin's (the twin
    on 2 blocks of 6 channels, the bottom array from channel 3)."""
    _c, const, templates = setup
    rng = np.random.default_rng(T + base_word)
    counts = np.array([0, 1, 500, 0, 40, 3, 0, 2, 900, 1, 0, 7])
    n = int(counts.sum())
    t = rng.integers(0, T * 10 + 300, n).astype(np.int32)
    gain = rng.uniform(1e5, 8e6, n).astype(np.float32)
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                               .astype(np.int32))
    args = (torch.from_numpy(t), torch.from_numpy(gain), row_ptr,
            torch.from_numpy(templates))
    kw = dict(n_channels=6, ch_block=0, n_top=3, n_tpc=5,
              current_2_adc=const.current_2_adc, n_samples=T)
    adc_r, sums_r = (x.numpy() for x in superpose_block_ref(*args, **kw))
    adc, sums, writes, _stats = emulate_block(*args, **kw,
                                              base_word=base_word)
    assert (writes == 1).all()
    np.testing.assert_array_equal(adc, adc_r)
    np.testing.assert_array_equal(sums, sums_r)


def test_block_negative_time_raises_on_cpu(setup):
    """A negative photon time raises, as the card's status word does."""
    _c, const, templates = setup
    t = torch.tensor([5, -1, 30], dtype=torch.int32)
    with pytest.raises(ValueError, match='>= 0'):
        superpose_block(t, torch.ones(3), torch.tensor([0, 3, 3],
                                                       dtype=torch.int32),
                        torch.from_numpy(templates), n_channels=2,
                        ch_block=0, n_top=1, n_tpc=2,
                        current_2_adc=const.current_2_adc, n_samples=64)
