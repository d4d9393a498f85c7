"""Regular-grid multilinear map lookup (counterpart of wfsim_tpu/ops/interp.py).

Every detector map is a regular grid with an optional trailing output
dimension (per-PMT patterns); lookups clamp to the grid boundary.  The
arithmetic follows ``wfsim_tpu.ops.interp.grid_lookup`` operation for
operation in float32, so both packages return the same values.

:func:`grid_lookup` is the lookup of every map on the path (LCE, patterns,
S2 correction, field distortion, gas gap): CPU tensors run its plain twin
:func:`grid_lookup_ref`, CUDA tensors the hand-written kernel
``csrc/grid_lookup.cu``.  Scattered-point maps are re-gridded once on the
host (:func:`regrid_scattered`), so the device only ever interpolates.
"""
from __future__ import annotations

import dataclasses
import typing as ty

import numpy as np
import torch

from .._build import Kernel, P, I, check_tensor, ptr, stream_of

__all__ = ['GridMap', 'grid_lookup', 'grid_lookup_ref', 'regrid_scattered']

#: the kernel takes grids of up to this many input dimensions
MAX_DIMS = 3


@dataclasses.dataclass
class GridMap:
    """values: (g1, ..., gN, out_dim) float32; lows / highs: (N,) float32.

    ``grid`` holds the kernel's grid constants, ``(d, (g1, g2, g3),
    out_dim)`` with the grid shape padded by 1 to ``MAX_DIMS`` (None for a
    map of more dimensions, which only the twin takes).  They are
    computed, and a map on the card is checked against what the kernel
    takes, when the map is built, moved (:meth:`to`) or a field is
    assigned, so a lookup checks only its points."""
    values: torch.Tensor
    lows: torch.Tensor
    highs: torch.Tensor

    def __setattr__(self, name, value):
        # the constants follow every assignment of a field (the resource
        # loader rescales maps in place), from __init__'s last one on
        super().__setattr__(name, value)
        if name in ('values', 'lows', 'highs') and 'highs' in self.__dict__:
            super().__setattr__('grid', _grid_constants(
                self.values, self.lows, self.highs))

    @classmethod
    def constant(cls, const: float, out_dim: int = 1, ndim_in: int = 1):
        """Constant map (role of the reference's DummyMap)."""
        shape = (2,) * ndim_in + (out_dim,)
        vals = np.full(shape, float(const), dtype=np.float32)
        return cls(torch.from_numpy(vals),
                   torch.zeros(ndim_in, dtype=torch.float32),
                   torch.ones(ndim_in, dtype=torch.float32))

    @classmethod
    def from_axes(cls, values: np.ndarray, axes: ty.Sequence[np.ndarray]):
        """Build from grid axis coordinate arrays (uniformly spaced; the
        loader resamples non-uniform axes before reaching here)."""
        values = np.asarray(values)
        if values.ndim == len(axes):
            values = values[..., None]
        lows = np.array([a[0] for a in axes], dtype=np.float32)
        highs = np.array([a[-1] for a in axes], dtype=np.float32)
        return cls(torch.from_numpy(np.ascontiguousarray(
            values.astype(np.float32))), torch.from_numpy(lows),
            torch.from_numpy(highs))

    @property
    def ndim_in(self) -> int:
        return self.values.dim() - 1

    @property
    def out_dim(self) -> int:
        return self.values.shape[-1]

    def to(self, device) -> 'GridMap':
        return GridMap(self.values.to(device), self.lows.to(device),
                       self.highs.to(device))

    def __call__(self, points):
        """Multilinear lookup at ``points``, as :func:`grid_lookup`."""
        dev = self.values.device
        if dev.type == 'cpu':
            return grid_lookup_ref(self.values, self.lows, self.highs, points)
        if dev.type != 'cuda':
            raise NotImplementedError(f'grid_lookup on {dev}')
        d, g, out_dim = self.grid
        if points.dim() == 1:
            points = points[:, None]
        if points.dtype != torch.float32 or not points.is_contiguous():
            points = points.to(torch.float32).contiguous()
        n = points.shape[0]
        check_tensor('points', points, torch.float32, (n, d), dev)
        if n >= 2 ** 31:
            raise ValueError(f'{n} points exceed the kernel\'s int32 count')
        out = torch.empty((n, out_dim) if out_dim > 1 else (n,),
                          dtype=torch.float32, device=dev)
        if n:
            _lookup_kernel(ptr(self.values), d, *g, out_dim, ptr(self.lows),
                           ptr(self.highs), ptr(points), n, ptr(out),
                           stream_of(dev))
        return out


def _grid_constants(values, lows, highs):
    """``(d, shape padded to MAX_DIMS, out_dim)`` of a map, or None past
    ``MAX_DIMS`` input dimensions; raises for a map on the card that the
    kernel does not take (dtype, shape, device, contiguity)."""
    d = values.dim() - 1
    dev = values.device
    if dev.type == 'cuda':
        if not 1 <= d <= MAX_DIMS:
            raise ValueError(f'a {d}-d map: the kernel takes 1 to {MAX_DIMS}')
        check_tensor('values', values, torch.float32, values.shape, dev)
        check_tensor('lows', lows, torch.float32, (d,), dev)
        check_tensor('highs', highs, torch.float32, (d,), dev)
    if not 1 <= d <= MAX_DIMS:
        return None
    g = tuple(int(x) for x in values.shape[:-1]) + (1,) * (MAX_DIMS - d)
    return d, g, int(values.shape[-1])


def _cell(values, lows, highs, points):
    """Lower grid index ``i0`` (n, d) int32 and fraction ``w`` (n, d)
    float32 of each point (wfsim_tpu interp.py:94-102)."""
    dev = values.device
    shape_i = torch.tensor(values.shape[:-1], dtype=torch.int32, device=dev)
    grid_shape = shape_i.to(torch.float32)
    span = torch.clamp_min(highs - lows, 1e-30)
    f = (points - lows) / span * (grid_shape - 1.0)
    f = torch.minimum(torch.clamp_min(f, 0.0), grid_shape - 1.0)
    i0 = torch.minimum(torch.clamp_min(torch.floor(f).to(torch.int32), 0),
                       shape_i - 1)
    return i0, f - i0.to(torch.float32)


def grid_lookup_ref(values, lows, highs, points):
    """Plain twin of :func:`grid_lookup` (any device)."""
    points = points.to(torch.float32)
    if points.dim() == 1:
        points = points[:, None]
    dev = values.device
    d = values.dim() - 1
    shape_i = torch.tensor(values.shape[:-1], dtype=torch.int32, device=dev)
    i0, w = _cell(values, lows, highs, points)

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


_lookup_kernel = Kernel('wfsim_grid_lookup', [P, I, I, I, I, I, P, P, P, I,
                                              P, P])


def grid_lookup(values, lows, highs, points):
    """Multilinear interpolation of ``values`` (grid shape + out_dim) at
    ``points`` (n, d) (or (n,) for a 1-d map), clamped to the grid
    (wfsim_tpu/ops/interp.py:85).  Returns (n, out_dim), or (n,) when
    out_dim == 1.

    CPU tensors run :func:`grid_lookup_ref`; CUDA tensors launch
    ``csrc/grid_lookup.cu`` (a thread per point for out_dim 1, a warp per
    point otherwise), with no read-back from the card.  Each call builds a
    :class:`GridMap` and so checks the map; callers on the card hold a
    :class:`GridMap`, which checks its map once, when it is built or
    moved."""
    return GridMap(values, lows, highs)(points)


def regrid_scattered(points: np.ndarray, values: np.ndarray,
                     n_grid: int = 50) -> GridMap:
    """Host-side: resample a scattered-point map (straxen's
    ``WeightedNearestNeighbors`` layout) onto a regular grid spanning the
    points' bounding box, so the device only does multilinear lookups
    (wfsim_tpu/ops/interp.py:126).  Grid-node values are straxen's
    estimator: inverse-distance (power 1) weighting over the ``2 * ndim``
    nearest points."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        values = values[:, None]
    d = points.shape[1]
    lows, highs = points.min(axis=0), points.max(axis=0)
    axes = [np.linspace(lows[i], highs[i], n_grid) for i in range(d)]
    mesh = np.meshgrid(*axes, indexing='ij')
    grid_pts = np.stack([mm.ravel() for mm in mesh], axis=1)

    tree = cKDTree(points)
    k = min(2 * d, len(points))
    dist, idx = tree.query(grid_pts, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    wgt = 1.0 / np.maximum(dist, 1e-12)
    wgt /= wgt.sum(axis=1, keepdims=True)
    est = np.einsum('nk,nko->no', wgt, values[idx])
    grid_vals = est.reshape(*(n_grid,) * d, values.shape[1])
    return GridMap.from_axes(grid_vals.astype(np.float32), axes)
