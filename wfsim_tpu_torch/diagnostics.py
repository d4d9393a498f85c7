"""Lightweight tracing / profiling.

The reference's only observability is a tqdm progress bar
(reference: wfsim/core/rawdata.py:70-71) — SURVEY s5.1 calls for phase timers
and photons/sec counters in the rebuild.  ``Timers`` accumulates wall time
and quantities per named phase; ``RawData`` exposes one as ``.diag`` and
the Simulator can report a summary.  For kernel-level profiling use
``torch.profiler`` — these hooks are orthogonal.  Phase times around device
work are host wall times; they include device time only where the phase
ends in a synchronising fetch.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager

log = logging.getLogger('wfsim_tpu_torch.diagnostics')

__all__ = ['Timers']


class Timers:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.counts = defaultdict(int)
        self.series = defaultdict(list)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def add(self, counter: str, n: int):
        self.counts[counter] += int(n)

    def append(self, name: str, value):
        """Record a per-call sample (kept as a list, not aggregated) —
        for distribution questions the summed counters can't answer."""
        self.series[name].append(value)

    def summary(self) -> dict:
        out = {f'{k}_s': round(v, 4) for k, v in self.seconds.items()}
        out.update({f'{k}_calls': v for k, v in self.calls.items()})
        out.update(dict(self.counts))
        total = sum(self.seconds.values())
        if total > 0 and self.counts.get('photons'):
            out['photons_per_sec'] = round(self.counts['photons'] / total, 1)
        if total > 0 and self.counts.get('records'):
            out['records_per_sec'] = round(self.counts['records'] / total, 1)
        return out

    def log_summary(self, level=logging.INFO):
        log.log(level, 'wfsim_tpu_torch timers: %s', self.summary())
