"""Instruction builders.  Only the bench workload of wfsim_tpu (bench.py:76-90
``_make_inst``) is ported; ``rand_instructions``, csv and optical input are
not."""
from __future__ import annotations

import numpy as np

from ..dtypes import instruction_dtype

__all__ = ['bench_instructions']


def bench_instructions(n: int = 512, amp_s1: int = 2000, amp_s2: int = 300):
    """``n`` events, each an S1 (amp ``amp_s1``) and an S2 (``amp_s2``
    electrons), 4 ms apart, at r < 45 cm and z in [-90, -10] cm; the same
    array as wfsim_tpu's bench.py ``_make_inst(n, amp_s1, amp_s2)``."""
    rng = np.random.default_rng(7)
    inst = np.zeros(2 * n, dtype=instruction_dtype)
    inst['event_number'] = np.repeat(np.arange(n), 2)
    inst['type'] = np.tile([1, 2], n)
    inst['time'] = np.repeat((np.arange(n) + 1) * 4_000_000, 2)
    r = np.sqrt(rng.uniform(0, 45 ** 2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    inst['x'] = np.repeat(r * np.cos(th), 2)
    inst['y'] = np.repeat(r * np.sin(th), 2)
    inst['z'] = np.repeat(rng.uniform(-90, -10, n), 2)
    inst['amp'] = np.tile([amp_s1, amp_s2], n)
    inst['recoil'] = 7
    return inst
