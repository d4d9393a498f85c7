"""Host-side utilities for optical (photon-list) instructions (a copy of
wfsim_tpu/utils.py; reference: wfsim/utils.py:61-165).

Normalize optical instruction timing to the first photon and split entries
with >1 us internal gaps into new instructions.  Timings (and channels) are
changed in place; split instructions are appended at the end.  These run
once per input file: host preprocessing, not a hot path.
"""
from __future__ import annotations

from copy import deepcopy

import numpy as np

PULSE_MAX_DURATION = int(1e3)
N_SPLIT_LOOP = 5

__all__ = ['optical_adjustment', 'find_optical_t_range',
           'PULSE_MAX_DURATION', 'N_SPLIT_LOOP']


def find_optical_t_range(firsts, lasts, timings, tmins, tmaxs, start=0):
    """Min/max photon time per entry; shift each entry's timings to start at
    zero (reference: wfsim/utils.py:61-86)."""
    for ix in range(start, len(firsts)):
        if firsts[ix] == lasts[ix]:
            tmins[ix] = -1
            tmaxs[ix] = -1
            continue
        seg = timings[firsts[ix]:lasts[ix]]
        tmins[ix] = seg.min()
        tmaxs[ix] = seg.max()
        timings[firsts[ix]:lasts[ix]] -= tmins[ix]


def _split_long_pulse(first, last, timings, channels):
    """Partition one entry's photons: move late photons (> PULSE_MAX_DURATION)
    to the front of the range and return the split point, mirroring the
    reference's in-place swap scheme (wfsim/utils.py:89-118)."""
    seg = slice(first, last)
    late = timings[seg] > PULSE_MAX_DURATION
    n_late = int(late.sum())
    if n_late == 0:
        return None
    order = np.argsort(~late, kind='stable')  # late photons first
    timings[seg] = timings[seg][order]
    channels[seg] = channels[seg][order]
    return first + n_late


def optical_adjustment(instructions, timings, channels):
    """Normalize optical instructions (reference: wfsim/utils.py:121-165):
    1) move each instruction's time to its first photon;
    2) split entries with >PULSE_MAX_DURATION internal gaps into new
       instructions appended at the end (up to N_SPLIT_LOOP passes).
    """
    instructions = instructions.copy()
    tmins = np.zeros(len(instructions), np.int64)
    tmaxs = np.zeros(len(instructions), np.int64)

    start = 0
    for _ in range(N_SPLIT_LOOP):
        find_optical_t_range(instructions['_first'], instructions['_last'],
                             timings, tmins, tmaxs, start=start)
        instructions['time'][start:] += tmins[start:]
        long_pulse = ((tmaxs - tmins) > PULSE_MAX_DURATION) \
            & (np.arange(len(instructions)) >= start)
        if long_pulse.sum() < 1:
            break

        extra = []
        for ix in np.where(long_pulse)[0]:
            split = _split_long_pulse(instructions['_first'][ix],
                                      instructions['_last'][ix],
                                      timings, channels)
            if split is None:
                continue
            tmp = deepcopy(instructions[ix])
            tmp['_first'] = instructions['_first'][ix]
            tmp['_last'] = split
            instructions['_first'][ix] = split
            extra.append(tmp)

        if not extra:
            break
        instructions = np.append(instructions, extra)
        tmins = np.hstack([tmins, np.zeros(len(extra), np.int64)])
        tmaxs = np.hstack([tmaxs, np.zeros(len(extra), np.int64)])
        start = len(instructions)

    return instructions
