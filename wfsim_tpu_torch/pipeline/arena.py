"""The host record arena: each digitize round's strax raw_record rows go
with one device-to-host copy into the next slice of one numpy base, so
every window's records, and every chunk the chunker cuts from
consecutive rounds, are views of that base (counterpart of wfsim_tpu's
``_arena_alloc``, pipeline/rawdata.py:1610-1641).

wfsim_tpu sizes a base by the rows of a whole run; a stream of 10^4
events would then hold gigabytes.  Here a new base holds at least the
most rows one chunk has taken in this process (:meth:`RecordArena.
note_chunk`, which the chunker calls for every chunk it hands out), and
at least the round that does not fit in the current one.  A base the
arena has left stays alive only as long as the views into it: the
chunker's pending windows and the chunks the caller keeps.

On the card a round's copy runs on a copy stream of its own and ends in
an event, so it overlaps the next super-batch's device work; the host
waits on the event only when it yields the round's windows.  The copy
lands in a pinned staging buffer from PyTorch's caching host allocator
(reused from round to round), which the host copies into the base once
the event has passed: on an H100 host page-locking a fresh base for the
copy to land in took an order of magnitude longer than that host copy
(PERF.md).  On the CPU the copy is a plain synchronous copy: the
same calls serve both devices.
"""
from __future__ import annotations

import typing as ty

import numpy as np
import torch

from ..dtypes import raw_record_dtype, DEFAULT_RECORD_LENGTH

__all__ = ['RecordArena', 'RoundCopy', 'RECORD_DTYPE']

RECORD_DTYPE = np.dtype(raw_record_dtype(DEFAULT_RECORD_LENGTH))

#: the copy stream of each device, made at its first use
_COPY_STREAMS: dict = {}


class RoundCopy(ty.NamedTuple):
    """One round's rows on their way into the arena: ``dest`` is their
    slice of the base; on the card ``event`` marks the end of the copy
    into the pinned buffer ``staged``."""
    dest: np.ndarray
    event: ty.Any = None
    staged: ty.Any = None


class RecordArena:
    """Consecutive slices of one numpy base of raw_record rows, filled by
    device-to-host copies (see the module docstring)."""

    #: the most rows one chunk has taken in this process: a new base holds
    #: at least this many (wfsim_tpu's high-water mark is process-level
    #: too, so each fresh Simulator of a bench loop fills one base)
    chunk_rows = 0

    def __init__(self):
        self._base: ty.Optional[np.ndarray] = None
        self._used = 0

    @classmethod
    def note_chunk(cls, n_rows: int):
        """Raise the high-water mark to a chunk of ``n_rows`` rows."""
        cls.chunk_rows = max(cls.chunk_rows, int(n_rows))

    def _alloc(self, n: int) -> np.ndarray:
        if self._base is None or self._used + n > len(self._base):
            # every byte of a slice is written by its copy: no zero fill
            self._base = np.empty(max(n, RecordArena.chunk_rows),
                                  RECORD_DTYPE)
            self._used = 0
        out = self._base[self._used:self._used + n]
        self._used += n
        return out

    def put(self, rows: torch.Tensor) -> RoundCopy:
        """Start the copy of a round's (N, 122) int16 rows into the next N
        slots; :meth:`wait` gives them as a raw_record array."""
        n = int(rows.shape[0])
        if n == 0:
            return RoundCopy(np.empty(0, RECORD_DTYPE))
        dest = self._alloc(n)
        if rows.device.type != 'cuda':
            torch.from_numpy(dest.view(np.int16).reshape(rows.shape)).copy_(
                rows)
            return RoundCopy(dest)
        stream = _COPY_STREAMS.get(rows.device)
        if stream is None:
            stream = _COPY_STREAMS[rows.device] = torch.cuda.Stream(
                rows.device)
        # the rows are written on the caller's stream; the copy stream
        # reads them, and record_stream keeps the caching allocator from
        # handing their memory out again before the copy ends, so the
        # caller may drop them at once
        stream.wait_stream(torch.cuda.current_stream(rows.device))
        with torch.cuda.stream(stream):
            staged = torch.empty(rows.shape, dtype=rows.dtype,
                                 pin_memory=True)
            staged.copy_(rows, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        rows.record_stream(stream)
        return RoundCopy(dest, event, staged)

    @staticmethod
    def wait(copy: RoundCopy) -> np.ndarray:
        """Block until a round's copy has ended; returns its records."""
        if copy.event is not None:
            copy.event.synchronize()
            torch.from_numpy(copy.dest.view(np.int16).reshape(
                copy.staged.shape)).copy_(copy.staged)
        return copy.dest
