"""Shared physics helpers (counterpart of wfsim_tpu/models/common.py)."""
from __future__ import annotations

import torch

from ..ops.randsample import uniform, exponential

__all__ = ['trunc_int', 'singlet_triplet_delays']


def trunc_int(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero (numpy's ``.astype(np.int64)``
    in the reference's timing draws)."""
    return torch.trunc(x).to(torch.int32)


def singlet_triplet_delays(gen, n: int, singlet_ratio, t1, t3, device):
    """Excimer decay delays: singlet or triplet lifetime per sample, then an
    exponential (reference: wfsim/core/pulse.py:320-341)."""
    is_singlet = uniform(gen, n, device) < singlet_ratio
    lifetime = torch.where(is_singlet, torch.tensor(float(t1), device=device),
                           torch.tensor(float(t3), device=device))
    return trunc_int(exponential(gen, n, device) * lifetime)
