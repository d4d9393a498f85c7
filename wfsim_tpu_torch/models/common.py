"""Shared physics helpers (counterpart of wfsim_tpu/models/common.py)."""
from __future__ import annotations

import torch

__all__ = ['trunc_int', 'f32', 'singlet_triplet_delays']


def trunc_int(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero (numpy's ``.astype(np.int64)``
    in the reference's timing draws)."""
    return torch.trunc(x).to(torch.int32)


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device.  A twin
    divides by this, never by a Python float: CUDA torch multiplies by the
    reciprocal of a host scalar where the CPU divides, so the quotient's
    last bit would depend on the device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def singlet_triplet_delays(u, exp, singlet_ratio, t1, t3):
    """Excimer decay delays from a uniform and an exponential draw per
    sample: the singlet lifetime where ``u < singlet_ratio``, else the
    triplet one (reference: wfsim/core/pulse.py:320-341)."""
    lifetime = torch.where(u < singlet_ratio,
                           torch.tensor(float(t1), device=u.device),
                           torch.tensor(float(t3), device=u.device))
    return trunc_int(exp * lifetime)
