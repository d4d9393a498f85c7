"""Ragged-axis helpers (counterpart of wfsim_tpu/ops/segment.py).

The physics is ragged: each instruction makes a different number of
electrons and photons.  In eager PyTorch the counts are known before any
buffer is allocated, so the ragged axes are exact (no padding, no
capacity), ``np.repeat`` becomes ``repeat_interleave`` and segment
boundaries come from a cumulative sum.  The TPU package's diff-scatter and
log-step reductions existed only because TPU gathers and scatters are slow
per index.
"""
from __future__ import annotations

import torch

__all__ = ['segment_ids_from_counts', 'edges_from_counts', 'expand_rows',
           'sorted_segment_sum', 'segment_min_max']


def segment_ids_from_counts(counts: torch.Tensor):
    """Segment id of every element of the exact-size ragged axis:
    ``repeat_interleave(arange(S), counts)`` (int64)."""
    counts = counts.to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)


def edges_from_counts(counts: torch.Tensor):
    """(S+1,) int64 segment boundaries: segment s is [edges[s], edges[s+1])."""
    out = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                      device=counts.device)
    out[1:] = torch.cumsum(counts.to(torch.int64), dim=0)
    return out


def expand_rows(vals: torch.Tensor, counts: torch.Tensor):
    """Broadcast per-segment values to the element axis."""
    return torch.repeat_interleave(vals, counts.to(torch.int64), dim=0)


def sorted_segment_sum(values: torch.Tensor, edges: torch.Tensor, valid=None):
    """Per-segment sums for contiguous ascending segments, as a float64
    cumulative sum differenced at the boundaries: exact for integer-valued
    inputs below 2^53 and deterministic on every device."""
    v = values.to(torch.float64)
    if valid is not None:
        v = torch.where(valid, v, 0.0)
    c = torch.zeros(v.shape[0] + 1, dtype=torch.float64, device=v.device)
    c[1:] = torch.cumsum(v, dim=0)
    return c[edges[1:]] - c[edges[:-1]]


def segment_min_max(values: torch.Tensor, seg_id: torch.Tensor,
                    n_segments: int, valid=None, big: int = 2 ** 31 - 1):
    """Per-segment (min, max) of int32 values; empty segments give
    (big, -big), the identities wfsim_tpu uses."""
    dev = values.device
    mn = torch.full((n_segments,), big, dtype=torch.int32, device=dev)
    mx = torch.full((n_segments,), -big, dtype=torch.int32, device=dev)
    v = values.to(torch.int32)
    if valid is not None:
        seg_id = seg_id[valid]
        v = v[valid]
    mn.scatter_reduce_(0, seg_id, v, reduce='amin')
    mx.scatter_reduce_(0, seg_id, v, reduce='amax')
    return mn, mx
