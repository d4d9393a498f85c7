"""Instruction builders and the analytic quanta partition.  Only the bench
workload of wfsim_tpu (bench.py:76-90 ``_make_inst``) is ported, with its
``detector_physics`` and ``timing_models`` variants; ``rand_instructions``, csv and optical input
are not.  ``step_instructions`` places bench events inside the grid of the
multi-device step (``parallel.sharding``)."""
from __future__ import annotations

import numpy as np

from ..dtypes import instruction_dtype

__all__ = ['bench_instructions', 'detector_physics_instructions',
           'timing_models_instructions', 'TIMING_MODEL_RECOILS',
           'step_instructions', 'analytic_yields']

#: the recoil ids ``timing_models_instructions`` cycles through, one per
#: class of the custom S1 model: ER (7), NR (0), alpha (6), LED (20)
TIMING_MODEL_RECOILS = (7, 0, 6, 20)

#: liquid-xenon W-value, keV per quantum
W_KEV = 13.7e-3


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


def detector_physics_instructions(n: int = 512, amp_s1: int = 2000,
                                  amp_s2: int = 300):
    """:func:`bench_instructions` with the inputs of the NEST S1 model set:
    ``local_field`` the default config's drift field, 82 V/cm, and
    ``e_dep`` the amplitude times the W-value (keV; 27.4 keV for the
    default S1s)."""
    inst = bench_instructions(n, amp_s1, amp_s2)
    inst['local_field'] = 82.0
    inst['e_dep'] = inst['amp'] * W_KEV
    return inst


def timing_models_instructions(n: int = 512, amp_s1: int = 2000,
                               amp_s2: int = 300):
    """:func:`bench_instructions` with the recoil id of event k
    ``TIMING_MODEL_RECOILS[k % 4]`` (on its S1 and its S2), so the
    ``custom`` S1 model runs all four of its classes."""
    inst = bench_instructions(n, amp_s1, amp_s2)
    inst['recoil'] = np.repeat(np.resize(np.asarray(TIMING_MODEL_RECOILS),
                                         n), 2)
    return inst


def step_instructions(config, n_blocks: int = 1, per_block: int = 64,
                      n_samples: int = 2 ** 16, amp_s1: int = 2000,
                      amp_s2: int = 300):
    """``n_blocks`` blocks of ``per_block`` instructions for
    ``make_sharded_step(inst_per_shard=per_block)``: per block
    ``per_block // 2`` bench events (:func:`bench_instructions`' positions
    and amplitudes, S1 then S2 of each event), their signals inside the
    block's grid of ``n_samples`` samples from time 0.  Event k of a block
    arrives at ``(0.05 + 0.85 k / (per_block // 2))`` of the grid: its S1
    at that time, its S2 that mean drift time (``drift_time_gate`` +
    depth / ``drift_velocity_liquid``) earlier, so the S2 light arrives
    with the S1's (the instruction time may be negative)."""
    n_ev = per_block // 2
    inst = bench_instructions(n_blocks * n_ev, amp_s1, amp_s2)
    span = n_samples * int(config['sample_duration'])
    k = np.arange(n_blocks * n_ev) % n_ev
    arrival = ((0.05 + 0.85 * k / n_ev) * span).astype(np.int64)
    drift = (-inst['z'][1::2] / config['drift_velocity_liquid']
             + config['drift_time_gate']).astype(np.int64)
    inst['time'][0::2] = arrival
    inst['time'][1::2] = arrival - drift
    return inst


def analytic_yields(energy_kev, drift_field, interaction_type=7, rng=None):
    """Approximate NEST total-quanta partition for ER (and crudely NR)
    (wfsim_tpu/interface/instructions.py:35, used when nestpy is missing).

    Thomas-Imel box recombination on top of W = 13.7 eV quanta production.
    Returns (photons, electrons, excitons) as integers."""
    W = W_KEV
    if interaction_type == 0:  # NR: Lindhard quenching
        eps = 11.5 * energy_kev * 54 ** (-7 / 3)
        g = 3 * eps ** 0.15 + 0.7 * eps ** 0.6 + eps
        L = 0.166 * g / (1 + 0.166 * g)
        n_q = int(energy_kev * L / W)
        exciton_ratio = 1.24 * (drift_field ** -0.0472) * (1 - np.exp(-239 * eps))
    else:
        n_q = int(energy_kev / W)
        exciton_ratio = 0.096
    n_ex = int(n_q * exciton_ratio / (1 + exciton_ratio))
    n_i = n_q - n_ex
    # Thomas-Imel recombination probability
    tib = 0.6347 * np.exp(-0.00014 * drift_field)
    xi = tib * max(n_i, 1) / 4.0
    r = 1.0 - np.log(1.0 + xi) / xi if xi > 1e-6 else 0.0
    n_ph = int(n_ex + r * n_i)
    n_el = max(n_q - n_ph, 0)
    return n_ph, n_el, n_ex
