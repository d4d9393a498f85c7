"""Window batches on the superposition kernels' code paths, shared by the
CPU tests (the twins against wfsim_tpu,
tests/test_torch_superpose_redesign.py) and the card-only tests (the
kernels against the twins, tests/test_torch_cuda.py); numpy only, so the
card's machine needs no JAX.

Each case is ``(t, ch, gain, pieces, T)``: an int32 / int32 / float32
photon arena on the first 64 channels (so it fits XENON1T's 248 too) and a
(B, 1, 3) int64 piece table of one piece a window, ``T`` samples a window.
The kernel gives a warp 1,024 samples of a row, from the row's first
16-byte boundary in the output, loads the row's photons 32 at a time and
stores 8 samples a lane; the cases reach the paths that follow from that.
"""
import numpy as np

SUPERPOSE_CASES = (
    'T = 8195',                       # 9 tiles, rows not aligned
    'a row with 3,000 photons',       # ~94 photon loads of 32 in one row
    'photons at the window end',      # taps cut at T, photons past T
    'an empty row and an empty window',
    'left not a multiple of 8',       # windows that start mid-group
)


def _window(rng, n, t_lo, t_hi, channels):
    t = rng.integers(t_lo, t_hi, n)
    ch = rng.choice(np.asarray(channels), n)
    return t, ch


def superpose_case(name):
    """The arena, pieces and window length of the named case."""
    rng = np.random.default_rng(SUPERPOSE_CASES.index(name))
    T = 1024
    wins = []
    if name == 'T = 8195':
        T = 8195
        wins.append(_window(rng, 1500, 0, T * 10, range(64)))
        wins.append(_window(rng, 600, T * 4, T * 6, range(0, 64, 3)))
    elif name == 'a row with 3,000 photons':
        t, ch = _window(rng, 3000, 1500, T * 10 - 3000, [3])
        t2, ch2 = _window(rng, 400, 1500, T * 10 - 3000, range(64))
        wins.append((np.concatenate([t, t2]), np.concatenate([ch, ch2])))
    elif name == 'photons at the window end':
        for w in range(2):
            parts = [_window(rng, 200, (T - 21) * 10, T * 10, range(20)),
                     _window(rng, 100, T * 10, T * 10 + 400, range(20)),
                     _window(rng, 100, (T - 60) * 10, (T - 21) * 10,
                             range(10 * w, 10 * w + 30))]
            wins.append(tuple(np.concatenate(x) for x in zip(*parts)))
    elif name == 'an empty row and an empty window':
        wins.append(_window(rng, 400, 1500, T * 10 - 3000, range(10)))
        wins.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
        wins.append(_window(rng, 300, 1500, T * 10 - 3000, [20, 21]))
    elif name == 'left not a multiple of 8':
        t, ch = [], []
        for c in range(64):
            s = 300 + 3 * c + rng.integers(0, 40, 5)
            s[0] = 300 + 3 * c                  # the row's first sample
            t.append(s * 10 + rng.integers(0, 10, 5))
            ch.append(np.full(5, c))
        wins.append((np.concatenate(t), np.concatenate(ch)))
    else:
        raise KeyError(name)
    pieces = np.zeros((len(wins), 1, 3), np.int64)
    lo = 0
    for w, (t, _ch) in enumerate(wins):
        pieces[w, 0] = (lo, len(t), 0)
        lo += len(t)
    t = np.concatenate([x[0] for x in wins]).astype(np.int32)
    ch = np.concatenate([x[1] for x in wins]).astype(np.int32)
    gain = rng.uniform(1e6, 3e6, len(t)).astype(np.float32)
    return t, ch, gain, pieces, T
