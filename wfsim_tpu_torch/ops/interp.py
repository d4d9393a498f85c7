"""Regular-grid multilinear map lookup (counterpart of wfsim_tpu/ops/interp.py).

Every detector map is a regular grid with an optional trailing output
dimension (per-PMT patterns); lookups clamp to the grid boundary.  The
arithmetic follows ``wfsim_tpu.ops.interp.grid_lookup`` operation for
operation in float32, so both packages return the same values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ['GridMap', 'grid_lookup']


@dataclasses.dataclass
class GridMap:
    """values: (g1, ..., gN, out_dim) float32; lows / highs: (N,) float32."""
    values: torch.Tensor
    lows: torch.Tensor
    highs: torch.Tensor

    @classmethod
    def constant(cls, const: float, out_dim: int = 1, ndim_in: int = 1):
        """Constant map (role of the reference's DummyMap)."""
        shape = (2,) * ndim_in + (out_dim,)
        vals = np.full(shape, float(const), dtype=np.float32)
        return cls(torch.from_numpy(vals),
                   torch.zeros(ndim_in, dtype=torch.float32),
                   torch.ones(ndim_in, dtype=torch.float32))

    def to(self, device) -> 'GridMap':
        return GridMap(self.values.to(device), self.lows.to(device),
                       self.highs.to(device))

    def __call__(self, points):
        return grid_lookup(self.values, self.lows, self.highs, points)


def grid_lookup(values, lows, highs, points):
    """Multilinear interpolation of ``values`` at ``points`` (n, d), clamped
    to the grid.  Returns (n, out_dim), or (n,) when out_dim == 1."""
    points = points.to(torch.float32)
    if points.dim() == 1:
        points = points[:, None]
    dev = values.device
    d = values.dim() - 1
    shape_i = torch.tensor(values.shape[:-1], dtype=torch.int32, device=dev)
    grid_shape = shape_i.to(torch.float32)
    span = torch.clamp_min(highs - lows, 1e-30)
    f = (points - lows) / span * (grid_shape - 1.0)
    f = torch.minimum(torch.clamp_min(f, 0.0), grid_shape - 1.0)
    i0 = torch.minimum(torch.clamp_min(torch.floor(f).to(torch.int32), 0),
                       shape_i - 1)
    w = f - i0.to(torch.float32)

    flat_vals = values.reshape(-1, values.shape[-1])
    strides = np.ones(d, dtype=np.int64)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * values.shape[k + 1]
    strides = torch.as_tensor(strides, dtype=torch.int32, device=dev)

    n = points.shape[0]
    out = torch.zeros((n, values.shape[-1]), dtype=values.dtype, device=dev)
    for corner in range(2 ** d):
        bits = [(corner >> k) & 1 for k in range(d)]
        idx = torch.minimum(
            i0 + torch.tensor(bits, dtype=torch.int32, device=dev), shape_i - 1)
        flat_idx = (idx * strides).sum(dim=1)
        weight = torch.ones(n, dtype=values.dtype, device=dev)
        for k, b in enumerate(bits):
            weight = weight * (w[:, k] if b else 1.0 - w[:, k])
        out = out + weight[:, None] * flat_vals[flat_idx]
    if values.shape[-1] == 1:
        return out[:, 0]
    return out
