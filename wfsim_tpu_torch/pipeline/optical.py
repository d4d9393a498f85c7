"""Optical-input raw data: the photons of S1 instructions come from a
GEANT4 photon list instead of S1 physics (counterpart of
wfsim_tpu/pipeline/optical.py; reference: wfsim/core/rawdata.py:461-496
``RawDataOptical``).

Type-1 instructions carry ``_first`` / ``_last`` indices into the given
(channels, timings) photon arrays.  Each instruction keeps its photons
with ``0 <= t < nveto_time_max_cutoff`` (default 1 ms), shifted by the
instruction's time; a batch's kept photons go to the device once, as
int32 times relative to the batch's base and int32 channels, and through
the PMT response (:func:`~wfsim_tpu_torch.models.pmt.pmt_response`: the
photon pass, the row truth with its time statistics and, with
``per_pmt_truth``, the per-PMT truth).  There is one truth row per
instruction whatever ``save_full_truth`` says.  The PMT afterpulses,
digitization and ZLE are those of the standard chain, and S2
instructions take the standard S2 chain.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.pmt import pmt_draws, pmt_response
from .rawdata import RawData

__all__ = ['RawDataOptical', 'optical_photons', 'optical_response']

#: photons at or after this time (ns after their instruction) are dropped
#: (wfsim_tpu optical.py:51, the config key ``nveto_time_max_cutoff``)
NVETO_TIME_MAX_CUTOFF = int(1e6)


def optical_photons(sel, timings, channels, base_time: int, cutoff: int):
    """The kept photons of the instructions ``sel``, instruction by
    instruction: ``(t, ch, counts)`` with ``t`` int32 ns after
    ``base_time``, ``ch`` int32 and ``counts`` (I,) int64 the photons each
    instruction keeps (wfsim_tpu optical.py:54-65)."""
    first = sel['_first'].astype(np.int64)
    n = np.maximum(sel['_last'].astype(np.int64) - first, 0)
    inst = np.repeat(np.arange(len(sel)), n)
    starts = np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64)
    pos = np.repeat(first - starts, n) + np.arange(int(n.sum()))
    tt = timings[pos]
    ok = (tt >= 0) & (tt < cutoff)
    inst = inst[ok]
    shift = sel['time'].astype(np.int64) - base_time
    t = (tt[ok] + shift[inst]).astype(np.int32)
    return t, channels[pos][ok].astype(np.int32), np.bincount(
        inst, minlength=len(sel)).astype(np.int64)


def optical_response(params, const, t, ch, counts, draws):
    """The PMT response of a batch of photons from a photon list (wfsim_tpu
    optical.py:20-30): ``t`` (N,) int32 and ``ch`` (N,) int32 on the
    device, grouped by instruction, ``counts`` the (I,) int64 photons of
    each instruction (a host tensor), ``draws`` from
    :func:`~wfsim_tpu_torch.models.pmt.pmt_draws`.  One truth row per
    instruction; returns :func:`~wfsim_tpu_torch.models.pmt.pmt_response`'s
    (photons, truth), which already holds the ``photon_*`` time statistics,
    with ``n_electron`` zeros."""
    dev = t.device
    n_rows = counts.shape[0]
    row_edges = torch.zeros(n_rows + 1, dtype=torch.int64)
    row_edges[1:] = torch.cumsum(counts, 0)
    truth_row = torch.repeat_interleave(torch.arange(n_rows), counts)
    photons, truth = pmt_response(
        params, const, t, ch, torch.ones(t.shape[0], dtype=torch.bool,
                                         device=dev),
        truth_row.to(dev), draws, n_truth_rows=n_rows,
        row_edges=row_edges.to(dev))
    truth['n_electron'] = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    return photons, truth


class RawDataOptical(RawData):
    """:class:`~wfsim_tpu_torch.pipeline.rawdata.RawData` whose S1
    instructions take their photons from ``channels`` / ``timings``
    (``interface.instructions.read_optical`` gives all three)."""

    def __init__(self, config, channels=tuple(), timings=tuple(), *,
                 device='cuda', mesh=None):
        super().__init__(config, device=device, mesh=mesh)
        self.channels = np.asarray(channels, dtype=np.int32)
        self.timings = np.asarray(timings, dtype=np.int64)

    def _truth_rows(self, instructions, idx, kind):
        if kind == 's1':
            return np.arange(len(idx), dtype=np.int64)
        return super()._truth_rows(instructions, idx, kind)

    def batch_photons(self, instructions, idx):
        """A batch's kept photons (:func:`optical_photons` relative to the
        batch's least instruction time, cut at ``nveto_time_max_cutoff``):
        (t, ch, counts)."""
        sel = instructions[idx]
        cutoff = int(self.config.get('nveto_time_max_cutoff',
                                     NVETO_TIME_MAX_CUTOFF))
        return optical_photons(sel, self.timings, self.channels,
                               int(np.min(sel['time'])), cutoff)

    def _physics(self, instructions, idx, kind, gen):
        if kind != 's1':
            return super()._physics(instructions, idx, kind, gen)
        dev = self.device
        t, ch, counts = self.batch_photons(instructions, idx)
        counts = torch.from_numpy(counts)
        photons, truth = optical_response(
            self.params, self.const, torch.as_tensor(t, device=dev),
            torch.as_tensor(ch, device=dev), counts,
            pmt_draws(gen, len(t), dev))
        return photons, truth, counts, len(idx)
