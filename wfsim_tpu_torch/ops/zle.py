"""Zero-length-encoding interval search (counterpart of wfsim_tpu/ops/zle.py).

Semantics of the reference's sequential hitfinder
(``find_intervals_below_threshold``, reference: wfsim/utils.py:14-58, used
by wfsim/core/rawdata.py:274-311): runs of samples below threshold, merged
across gaps of at most ``holdoff`` samples, padded by +-trigger_window,
clipped to the channel window and landed on even offsets.

On the card one hand-written kernel scans each row
(``csrc/zle_intervals.cu``).  ``zle_all_channels_ref`` is its plain PyTorch
twin, the data-parallel formulation of wfsim_tpu (cumulative sums and
shifted window sums); both return the same arrays, sentinel slots
included.
"""
from __future__ import annotations

import torch

from .._build import Kernel, P, I, ptr, stream_of

__all__ = ['find_intervals', 'zle_all_channels', 'zle_all_channels_ref']

_BIG = 2 ** 30


def find_intervals(below: torch.Tensor, *, holdoff: int, max_intervals: int):
    """All-row interval finder on a (R, T) bool mask.  Returns starts
    (R, K), ends (R, K) (absolute sample indices; unused slots 2^30 and
    -2^30) and counts (R,) capped at K."""
    R, T = below.shape
    dev = below.device
    K = max_intervals
    csum_p = torch.zeros((R, T + 1), dtype=torch.int32, device=dev)
    csum_p[:, 1:] = torch.cumsum(below.to(torch.int32), dim=1)
    idx = torch.arange(T, device=dev)

    def shifted(s):
        # csum_p[:, clip(i + s, 0, T)]: number of below samples before i + s
        return csum_p[:, torch.clamp(idx + s, 0, T)]

    prev_any = (shifted(0) - shifted(-holdoff)) > 0
    next_any = (shifted(holdoff + 1) - shifted(1)) > 0
    new_start = below & ~prev_any
    is_end = below & ~next_any

    def first_k(mask):
        rank = torch.cumsum(mask.to(torch.int32), dim=1) - 1
        keep = mask & (rank < K)
        out = torch.full((R, K), _BIG, dtype=torch.int32, device=dev)
        rows, cols = torch.nonzero(keep, as_tuple=True)
        out[rows, rank[rows, cols].to(torch.int64)] = cols.to(torch.int32)
        return out

    starts = first_k(new_start)
    ends = first_k(is_end)
    counts = torch.clamp_max(new_start.sum(dim=1), K).to(torch.int32)
    ends = torch.where(ends >= _BIG, -_BIG, ends).to(torch.int32)
    return starts, ends, counts


def _clip(x, lo, hi):
    # jnp.clip order: maximum with lo first, then minimum with hi
    return torch.minimum(torch.maximum(x, lo), hi)


def zle_all_channels_ref(data, thresholds, ch_left, ch_right, ch_mask, *,
                         holdoff: int, trigger_window: int,
                         max_intervals: int):
    """Plain twin of the zle_intervals kernel.

    :param data: (R, T) int16 digitized grid
    :param thresholds: (R,) int32 ZLE threshold per row (ADC)
    :param ch_left/ch_right: (R,) int32 active window per row
    :param ch_mask: (R,) bool rows that hold photons
    :returns: starts, ends (R, K) int32 relative to ``ch_left``, counts (R,)
    """
    R, T = data.shape
    idx = torch.arange(T, dtype=torch.int32, device=data.device)
    in_window = ((idx[None, :] >= ch_left[:, None])
                 & (idx[None, :] <= ch_right[:, None]))
    below = (data.to(torch.int32) < thresholds[:, None]) & in_window \
        & ch_mask[:, None]
    starts, ends, counts = find_intervals(below, holdoff=holdoff,
                                          max_intervals=max_intervals)
    zero = torch.zeros((), dtype=torch.int32, device=data.device)
    hi = (ch_right - ch_left)[:, None]
    starts = _clip(starts - ch_left[:, None] - trigger_window, zero, hi)
    ends = _clip(ends - ch_left[:, None] + trigger_window, zero, hi)
    starts = torch.div(starts + 1, 2, rounding_mode='floor') * 2
    ends = torch.div(ends, 2, rounding_mode='floor') * 2
    counts = torch.where(ch_mask, counts, 0).to(torch.int32)
    return starts.to(torch.int32), ends.to(torch.int32), counts


_kernel = Kernel('wfsim_zle_intervals', [P, I, I, P, P, P, P, I, I, I, P, P, P, P])


def zle_all_channels(data, thresholds, ch_left, ch_right, ch_mask, *,
                     holdoff: int, trigger_window: int, max_intervals: int):
    """ZLE intervals of every row: CPU tensors go to
    :func:`zle_all_channels_ref`; CUDA tensors launch the hand-written kernel
    (``csrc/zle_intervals.cu``)."""
    R, T = data.shape
    dev = data.device
    if data.dtype != torch.int16 or not data.is_contiguous():
        raise TypeError('data must be a contiguous int16 (rows, T) grid')
    for name, x, dt in (('thresholds', thresholds, torch.int32),
                        ('ch_left', ch_left, torch.int32),
                        ('ch_right', ch_right, torch.int32),
                        ('ch_mask', ch_mask, torch.bool)):
        if x.dtype != dt or tuple(x.shape) != (R,) or x.device != dev \
                or not x.is_contiguous():
            raise TypeError(f'{name}: need contiguous {dt} ({R},) on {dev}, '
                            f'got {x.dtype} {tuple(x.shape)} on {x.device}')
    kw = dict(holdoff=holdoff, trigger_window=trigger_window,
              max_intervals=max_intervals)
    if dev.type == 'cpu':
        return zle_all_channels_ref(data, thresholds, ch_left, ch_right,
                                    ch_mask, **kw)
    if dev.type != 'cuda':
        raise NotImplementedError(f'zle_all_channels on {dev}')
    K = max_intervals
    starts = torch.empty((R, K), dtype=torch.int32, device=dev)
    ends = torch.empty((R, K), dtype=torch.int32, device=dev)
    counts = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0:
        return starts, ends, counts
    _kernel(ptr(data), R, T, ptr(thresholds), ptr(ch_left), ptr(ch_right),
            ptr(ch_mask), holdoff, trigger_window, K, ptr(starts), ptr(ends),
            ptr(counts), stream_of(dev))
    return starts, ends, counts
