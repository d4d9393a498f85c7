"""Helpers of the metric readers (``metrics/<name>.py``).

A reader's ``read(ctx)`` gets the run's context: ``events`` (events
delivered in the window), ``window_s``, ``setup_s``, ``peak_bytes``,
``timers`` (the program's ``Timers`` seconds by phase over the window,
less the profiled span and less the benchmark's own time) with
``timed_events`` (the events they cover), ``trace`` (the traced span:
``busy_s``, ``window_s``, device seconds by kernel, or None) and
``roofline`` ({key: (bound seconds, device seconds, calls)} of the traced
calls).  It returns a number, or
None where the run has nothing to read.
"""
from __future__ import annotations


def ms_per_kevent(ctx, *phases):
    """Host milliseconds of the Timers phases per 1,000 delivered events."""
    if not ctx['timed_events']:
        return None
    seconds = sum(ctx['timers'].get(p, 0.0) for p in phases)
    return seconds * 1e3 / (ctx['timed_events'] / 1e3)


def roofline_pct(ctx, key):
    """100 x the summed bounds over the summed device time of the traced
    calls of ``key``; None without calls or device time."""
    got = ctx['roofline'].get(key)
    if not got or got[1] <= 0:
        return None
    bound, device, _calls = got
    return 100.0 * bound / device
