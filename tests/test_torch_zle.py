"""ZLE interval search of wfsim_tpu_torch (the CPU twin of the zle_intervals
kernel) against wfsim_tpu.ops.zle and the sequential reference oracle.

Rows carry below-threshold runs separated by gaps on both sides of the
holdoff, runs touching the window edges, below-threshold samples outside
the window (which must be ignored), rows without photons, and more runs
than the K output slots.

Tolerance: bitwise — starts, ends (every slot, sentinels included) and
counts.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from wfsim_tpu.ops.zle import (zle_all_channels as jax_zle,
                               find_intervals as jax_find_intervals)
from wfsim_tpu_torch.ops.zle import zle_all_channels, find_intervals

from .reference_semantics import intervals_below_threshold

BASE, THR = 16000, 15984


def random_rows(seed, R, T, holdoff):
    rng = np.random.default_rng(seed)
    data = (BASE + rng.integers(-3, 4, (R, T))).astype(np.int16)
    left = rng.integers(0, T // 4, R)
    right = rng.integers(3 * T // 4, T, R)
    left[:3] = 0                     # windows on the grid edges
    right[:3] = T - 1
    has = rng.random(R) > 0.1
    for r in range(R):
        x = int(left[r]) + int(rng.integers(-5, 40))
        while x < right[r] + 10:
            run = int(rng.integers(1, 30))
            lo, hi = max(x, 0), min(x + run, T)
            data[r, lo:hi] = THR - rng.integers(1, 400, max(hi - lo, 0))
            # gaps just under, at and just over the holdoff bridge
            x += run + int(rng.choice([1, holdoff - 1, holdoff, holdoff + 1,
                                       holdoff + 2, 3 * holdoff]))
    return data, left.astype(np.int32), right.astype(np.int32), has


def oracle(data, left, right, has, holdoff, tw, K):
    """Reference intervals, padded/clipped/even-aligned, first K per row."""
    out = []
    for r in range(len(data)):
        if not has[r]:
            out.append([])
            continue
        seg = data[r, left[r]:right[r] + 1].astype(np.int64)
        itv = intervals_below_threshold(seg, THR, holdoff)
        n = len(seg)
        res = []
        for lo, hi in itv[:K]:
            lo2 = min(max(lo - tw, 0), n - 1)
            hi2 = min(max(hi + tw, 0), n - 1)
            res.append((((lo2 + 1) // 2) * 2, (hi2 // 2) * 2))
        out.append(res)
    return out


CASES = [
    # (seed, rows, T, holdoff, trigger_window, K)
    (0, 48, 1024, 101, 50, 64),   # main-path rule; JAX block-compressed path
    (1, 48, 1024, 101, 50, 4),    # more intervals than slots
    (2, 32, 1000, 101, 50, 16),   # T not a multiple of 64: JAX top_k path
    (3, 32, 512, 7, 3, 8),        # short holdoff: JAX top_k path
]


@pytest.mark.parametrize('seed,R,T,holdoff,tw,K', CASES)
def test_zle_twin_matches_jax_and_oracle(seed, R, T, holdoff, tw, K):
    data, left, right, has = random_rows(seed, R, T, holdoff)
    thr = np.full(R, THR, np.int32)
    js, je, jc = jax_zle(jnp.asarray(data.astype(np.int32)), jnp.asarray(thr),
                         jnp.asarray(left), jnp.asarray(right),
                         jnp.asarray(has), holdoff=holdoff, trigger_window=tw,
                         max_intervals=K)
    ts, te, tc = zle_all_channels(
        torch.from_numpy(data), torch.from_numpy(thr), torch.from_numpy(left),
        torch.from_numpy(right), torch.from_numpy(has), holdoff=holdoff,
        trigger_window=tw, max_intervals=K)
    for name, a, b in (('starts', js, ts), ('ends', je, te),
                       ('counts', jc, tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert int(tc.sum()) > R           # the rows really hold intervals
    if K <= 8:
        assert int((tc == K).sum()) > 0   # some rows overflow the slots

    ref = oracle(data, left, right, has, holdoff, tw, K)
    for r in range(R):
        n = int(tc[r])
        assert n == len(ref[r]), r
        got = list(zip(ts[r, :n].tolist(), te[r, :n].tolist()))
        assert got == ref[r], r


@pytest.mark.parametrize('seed,T,holdoff', [(4, 1024, 101), (5, 640, 13)])
def test_find_intervals_matches_jax(seed, T, holdoff):
    rng = np.random.default_rng(seed)
    below = rng.random((40, T)) < rng.uniform(0.001, 0.05, (40, 1))
    a = jax_find_intervals(jnp.asarray(below), holdoff=holdoff,
                           max_intervals=32)
    b = find_intervals(torch.from_numpy(below), holdoff=holdoff,
                       max_intervals=32)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_zle_wrapper_rejects_bad_input():
    data = torch.full((2, 64), BASE, dtype=torch.int16)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        zle_all_channels(data.to(torch.int32), i32, i32, i32,
                         torch.ones(2, dtype=torch.bool), holdoff=5,
                         trigger_window=2, max_intervals=4)
    with pytest.raises(TypeError):
        zle_all_channels(data, i32, i32, i32, torch.ones(3, dtype=torch.bool),
                         holdoff=5, trigger_window=2, max_intervals=4)
