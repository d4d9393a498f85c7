"""Sampling primitives (counterpart of wfsim_tpu/ops/randsample.py).

Searches are ``torch.searchsorted`` over the per-row tables flattened into
one sorted int64 key sequence: each float32 value maps to an
order-preserving 32-bit key, and the row index sits in the high bits, so a
single search answers every sample against its own row, exactly as the
per-row search of wfsim_tpu would.  Random draws take an explicit
``torch.Generator``.

:func:`channel_draw` is the photon chains' channel draw: CPU tensors run
its plain twin :func:`channel_draw_ref`, CUDA tensors the hand-written
kernel ``csrc/channel_draw.cu``.
"""
from __future__ import annotations

import torch

from .._build import Kernel, P, I, check_tensor, ptr, stream_of
from .segment import segment_ids_from_counts

__all__ = ['categorical_from_cdf', 'search_sorted_rows', 'cumsum_f64',
           'channel_draw', 'channel_draw_ref', 'binomial', 'poisson',
           'uniform', 'normal', 'exponential']


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key in [0, 2^32) of float32 (or int32) values."""
    if x.dtype == torch.float32:
        bits = (x + 0.0).contiguous().view(torch.int32)   # -0.0 -> +0.0
        bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    else:
        bits = x.to(torch.int32)
    return bits.to(torch.int64) + 2 ** 31


def search_sorted_rows(tab: torch.Tensor, row_idx: torch.Tensor,
                       q: torch.Tensor, *, side: str = 'right'):
    """Per-sample searchsorted on per-row NONDECREASING tables (R, C): the
    smallest i with ``tab[row, i] > q`` (side='right') or ``>= q``
    (side='left'), clamped to [0, C-1]."""
    R, C = tab.shape
    rows = torch.arange(R, device=tab.device, dtype=torch.int64)
    keys = (rows[:, None] << 32) | _order_key(tab)
    row_idx = row_idx.to(torch.int64)
    qk = (row_idx << 32) | _order_key(q.to(tab.dtype))
    g = torch.searchsorted(keys.reshape(-1), qk, right=(side == 'right'))
    return torch.clamp_max(g - row_idx * C, C - 1).to(torch.int32)


def categorical_from_cdf(cdf_rows: torch.Tensor, row_idx: torch.Tensor,
                         u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical draw per sample (the reference's per-event
    ``np.random.choice(channels, p=pattern)``, wfsim/core/s1.py:152-158).

    :param cdf_rows: (R, C) float32 inclusive CDFs, last column = row mass
    :param row_idx: (N,) which row each sample draws from
    :param u: (N,) float32 uniforms in [0, 1)
    :returns: (N,) int32 categories; -1 where the row has zero mass
    """
    total = cdf_rows[:, -1][row_idx.to(torch.int64)]
    target = u * total
    out = search_sorted_rows(cdf_rows, row_idx, target, side='right')
    return torch.where(total > 0, out, -1).to(torch.int32)


def cumsum_f64(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 cumulative sum accumulated in float64, each output rounded
    to float32 once.  torch's CPU cumsum of float32 does exactly this, in
    sequence; its CUDA cumsum scans float32 in parallel and gives other
    last bits, so the twins write it out.  On the card the float64 scan
    runs in parallel too: it agrees with the sequential sum wherever the
    float64 partial sums are exact (nonnegative float32 inputs within a
    2^20 dynamic range over <= 512 terms, for example)."""
    return torch.cumsum(x.to(torch.float64), dim).to(torch.float32)


def channel_draw_ref(pattern: torch.Tensor, edges: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`channel_draw` on any device."""
    rows = segment_ids_from_counts(edges[1:] - edges[:-1])
    return categorical_from_cdf(cumsum_f64(pattern, 1), rows, u)


_draw_kernel = Kernel('wfsim_channel_draw', [P, I, I, P, P, I, P, P, P])


def channel_draw(pattern: torch.Tensor, edges: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """Channel of every photon from its instruction's pattern (wfsim_tpu
    models/s1.py:162-170 and models/s2.py:355-374: the pattern cumsum, then
    :func:`categorical_from_cdf`).

    :param pattern: (I, C) float32 masked pattern (map lookup x live mask)
    :param edges: (I+1,) int64 photon boundaries: instruction i owns the
        photons [edges[i], edges[i+1])
    :param u: (N,) float32 uniforms, N = edges[-1]
    :returns: (N,) int32 channels, -1 where the row has no mass

    The CDF is :func:`cumsum_f64` of the pattern.  CPU tensors run
    :func:`channel_draw_ref` and raise unless ``edges[-1] == N``.  CUDA
    tensors launch ``csrc/channel_draw.cu`` and read nothing back from the
    card: ``edges[-1]`` is not checked against N there (the callers build
    ``edges`` and ``u`` from the same counts); the kernel writes the N
    channels and nothing else, -1 for a photon outside ``[edges[0],
    edges[-1])``."""
    dev = pattern.device
    I, C = pattern.shape
    n = u.shape[0]
    check_tensor('pattern', pattern, torch.float32, (I, C), dev)
    check_tensor('edges', edges, torch.int64, (I + 1,), dev)
    check_tensor('u', u, torch.float32, (n,), dev)
    if dev.type == 'cpu':
        if int(edges[-1]) != n:
            raise ValueError(f'{n} uniforms for {int(edges[-1])} photons')
        return channel_draw_ref(pattern, edges, u)
    if dev.type != 'cuda':
        raise NotImplementedError(f'channel_draw on {dev}')
    if n >= 2 ** 31:
        raise ValueError(f'{n} photons exceed the kernel\'s int32 count')
    ch = torch.empty(n, dtype=torch.int32, device=dev)
    if n and I:
        cdf = torch.empty((I, C), dtype=torch.float32, device=dev)
        _draw_kernel(ptr(pattern), I, C, ptr(edges), ptr(u), n, ptr(cdf),
                     ptr(ch), stream_of(dev))
    elif n:
        ch.fill_(-1)                     # no instruction owns a photon
    return ch


# ---------------------------------------------------------------------------
# Draws (explicit generator; float32 like wfsim_tpu's jax.random calls)


def uniform(gen, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=device, dtype=torch.float32)


def normal(gen, n: int, device) -> torch.Tensor:
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32)


def exponential(gen, n: int, device) -> torch.Tensor:
    return torch.empty(n, device=device, dtype=torch.float32).exponential_(
        1.0, generator=gen)


def binomial(gen, n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Binomial(n, p) elementwise, 0 where n <= 0 or p <= 0 (int32)."""
    nf = torch.clamp_min(n.to(torch.float32), 0.0)
    pf = torch.clamp(p.to(torch.float32), 0.0, 1.0)
    out = torch.binomial(nf, pf, generator=gen)
    return torch.where((nf <= 0) | (pf <= 0), 0.0, out).to(torch.int32)


def poisson(gen, lam: torch.Tensor) -> torch.Tensor:
    """Poisson(lam) elementwise, 0 where lam <= 0 (int32)."""
    lam = lam.to(torch.float32)
    out = torch.poisson(torch.clamp_min(lam, 0.0), generator=gen)
    return torch.where(lam <= 0, 0.0, out).to(torch.int32)
