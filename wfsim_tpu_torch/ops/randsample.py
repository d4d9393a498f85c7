"""Sampling primitives (counterpart of wfsim_tpu/ops/randsample.py).

Searches are ``torch.searchsorted`` over the per-row tables flattened into
one sorted int64 key sequence: each float32 value maps to an
order-preserving 32-bit key, and the row index sits in the high bits, so a
single search answers every sample against its own row, exactly as the
per-row search of wfsim_tpu would.  Random draws take an explicit
``torch.Generator``.
"""
from __future__ import annotations

import torch

__all__ = ['categorical_from_cdf', 'search_sorted_rows', 'binomial',
           'poisson', 'uniform', 'normal', 'exponential']


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
