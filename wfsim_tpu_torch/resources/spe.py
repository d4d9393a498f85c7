"""SPE gain inverse-CDF tables.

The reference converts each channel's measured SPE charge spectrum into a
2001-point uniform->gain lookup grid (reference: wfsim/core/pulse.py:189-227).
The port keeps that representation (one table read per photon): ``uniform_to_pe[channel, int(u * 2000) + 1]``.
"""
from __future__ import annotations

import csv
import io

import numpy as np

__all__ = ['build_uniform_to_pe', 'spe_table_from_csv']

GRID_POINTS = 2001


def build_uniform_to_pe(charge: np.ndarray, pdfs: np.ndarray) -> np.ndarray:
    """(n_channels, GRID_POINTS) uniform->SPE-gain table.

    Matches the reference construction exactly (pulse.py:200-217): per-channel
    CDF over the charge axis, then a 'next'-kind inverse lookup on a uniform
    grid with edge clamping.
    """
    pdfs = np.atleast_2d(pdfs)
    n_ch = pdfs.shape[0]
    out = np.zeros((n_ch, GRID_POINTS), dtype=np.float32)
    grid_cdf = np.linspace(0, 1, GRID_POINTS)
    for ch in range(n_ch):
        pdf = pdfs[ch]
        total = pdf.sum()
        if total <= 0:
            continue
        cdf = np.cumsum(pdf) / total
        # 'next' interpolation: value at the smallest tabulated cdf >= query
        idx = np.searchsorted(cdf, grid_cdf, side='left')
        idx = np.clip(idx, 0, len(charge) - 1)
        vals = charge[idx]
        vals[grid_cdf < cdf[0]] = charge[0]
        vals[grid_cdf > cdf[-1]] = charge[-1]
        out[ch] = vals
    return out


def _read_csv_columns(path_or_buf):
    """(header, float64 rows) of a csv file, path or csv text (the csv
    module and Python's correctly rounded float parsing; no pandas)."""
    if isinstance(path_or_buf, bytes):
        path_or_buf = path_or_buf.decode()
    if isinstance(path_or_buf, str) and not path_or_buf.endswith('.csv'):
        rows = list(csv.reader(io.StringIO(path_or_buf)))
    elif hasattr(path_or_buf, 'read'):
        rows = list(csv.reader(path_or_buf))
    else:
        with open(path_or_buf, newline='') as f:
            rows = list(csv.reader(f))
    rows = [r for r in rows if r]
    header = [h.strip() for h in rows[0]]
    values = np.array([[float(x) for x in r] for r in rows[1:]],
                      dtype=np.float64).reshape(-1, len(header))
    return header, values


def spe_table_from_csv(path_or_buf, n_channels: int) -> np.ndarray:
    """Load a reference-format SPE distribution CSV (a 'charge' column plus
    one pdf column per channel; an unnamed leading index column is
    skipped; single-channel files are broadcast to all channels, like the
    reference tests do at tests/test_wfsim.py:82-88)."""
    header, values = _read_csv_columns(path_or_buf)
    cols = [i for i, h in enumerate(header)
            if h != 'charge' and h and not h.startswith('Unnamed')]
    charge = values[:, header.index('charge')]
    pdfs = values[:, cols].T
    if pdfs.shape[0] == 1 and n_channels > 1:
        pdfs = np.tile(pdfs, (n_channels, 1))
    if pdfs.shape[0] < n_channels:
        reps = int(np.ceil(n_channels / pdfs.shape[0]))
        pdfs = np.tile(pdfs, (reps, 1))[:n_channels]
    return build_uniform_to_pe(charge, pdfs[:n_channels])
