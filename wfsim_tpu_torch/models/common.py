"""Shared physics helpers (counterpart of wfsim_tpu/models/common.py)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['trunc_int', 'f32', 'sqrt_f32', 'singlet_triplet_delays',
           'skew_normal', 'rz_lookup', 'check_edges', 'check_segments']


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


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 ``x``, on any
    device: the float64 root rounded once (a float64 root within one ulp
    rounds to the correct float32).  CPU torch's vectorised float32 root
    is one ulp off for some values; CUDA torch's float32 root and JAX's
    are correctly rounded."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def singlet_triplet_delays(u, exp, singlet_ratio, t1, t3):
    """Excimer decay delays from a uniform and an exponential draw per
    sample: the singlet lifetime where ``u < singlet_ratio``, else the
    triplet one (reference: wfsim/core/pulse.py:320-341)."""
    lifetime = torch.where(u < singlet_ratio,
                           torch.tensor(float(t1), device=u.device),
                           torch.tensor(float(t3), device=u.device))
    return trunc_int(exp * lifetime)


def skew_normal(u0, v, loc, scale, a):
    """Azzalini skew-normal values from two standard normals per sample
    (wfsim_tpu/models/common.py skew_normal; scipy.stats.skewnorm.rvs, the
    reference's S2 area-fraction-top smearing, s2.py:660-665):
    ``loc + scale * (delta * |u0| + sqrt(1 - delta^2) * v)`` with
    ``delta = a / sqrt(1 + a^2)``.  The two coefficients are float32
    values rounded on the host as JAX rounds them."""
    f = np.float32
    delta = f(a) / np.sqrt(f(1.0 + a ** 2))
    comp = np.sqrt(f(1) - delta * delta)
    z = float(delta) * torch.abs(u0) + float(comp) * v
    return loc + scale * z


def rz_lookup(gridmap, z, xy):
    """An (r, z) map at cartesian positions (wfsim_tpu/models/common.py:54;
    the reference wraps its field-dependency maps the same way,
    load_resource.py:335-338): (n,) float32 for a one-output map."""
    r = sqrt_f32(xy[:, 0] * xy[:, 0] + xy[:, 1] * xy[:, 1])
    out = gridmap(torch.stack([r, z], dim=1))
    return out[..., 0] if out.dim() > 1 else out


def check_edges(edges, n: int, what: str):
    """The CPU paths' check that the edges end at the ``n`` elements (on the
    card the kernels clamp them instead: no read-back)."""
    if edges.device.type == 'cpu' and int(edges[-1]) != n:
        raise ValueError(f'{what}: the edges end at {int(edges[-1])}, not '
                         f'at {n}')


def check_segments(n: int, n_seg: int, what: str):
    """Elements need a segment: raised on the host, where the CPU paths
    raise by the edges' check (an empty edge array ends at 0)."""
    if n and not n_seg:
        raise ValueError(f'{what}: {n} elements and no segments')
