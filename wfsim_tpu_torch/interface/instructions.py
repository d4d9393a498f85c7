"""Instruction generation: the bench workload of wfsim_tpu (bench.py:76-90
``_make_inst``) with its ``detector_physics`` and ``timing_models``
variants, random events, csv input and GEANT4 optical input (counterpart
of wfsim_tpu/interface/instructions.py; reference:
wfsim/strax_interface.py:119-350).  ``step_instructions`` places bench
events inside the grid of the multi-device step (``parallel.sharding``).

Random events take their quanta from the C++ ``nestpy`` library when it is
importable, else from the analytic ER/NR partition of wfsim_tpu
(:func:`analytic_yields`); both only seed the Monte Carlo.  Everything
here is host numpy: for the same inputs the arrays equal wfsim_tpu's."""
from __future__ import annotations

import logging
import typing as ty

import numpy as np

from ..dtypes import instruction_dtype, optical_extra_dtype

log = logging.getLogger('wfsim_tpu_torch.interface')

__all__ = ['bench_instructions', 'detector_physics_instructions',
           'timing_models_instructions', 'TIMING_MODEL_RECOILS',
           'step_instructions', 'analytic_yields', 'rand_instructions',
           'random_instructions', '_rand_instructions',
           'instruction_from_csv', 'read_optical']

try:
    import nestpy
    HAVE_NESTPY = True
except ImportError:
    nestpy = None
    HAVE_NESTPY = False

DEFAULT_TPC_LENGTH = 148.6515  # straxen.tpc_z
DEFAULT_TPC_RADIUS = 66.4      # straxen.tpc_r

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
    Returns (photons, electrons, excitons) as integers; ``rng`` is not
    drawn from (wfsim_tpu's signature)."""
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


def rand_instructions(c) -> np.ndarray:
    """Config-dict driven random instruction generator (wfsim_tpu
    instructions.py:64; reference: strax_interface.py:119-135)."""
    log.warning('rand_instructions is deprecated, use random_instructions')
    return _rand_instructions(
        event_rate=c.get('event_rate', 10),
        chunk_size=c.get('chunk_size', 5),
        n_chunk=c.get('n_chunk', 2),
        energy_range=[1, 100],
        drift_field=c.get('drift_field', 100),
        tpc_radius=c.get('tpc_radius', DEFAULT_TPC_RADIUS),
        tpc_length=c.get('tpc_length', DEFAULT_TPC_LENGTH),
        nest_inst_types=[7],
        seed=c.get('seed') or None,
    )


def random_instructions(**kwargs) -> np.ndarray:
    """Generate instructions for simulation (reference: strax_interface.py:
    138-152).  See :func:`_rand_instructions` for parameters."""
    return _rand_instructions(**kwargs)


def _rand_instructions(
        event_rate: int,
        chunk_size: int,
        n_chunk: int,
        drift_field: float,
        energy_range,
        tpc_length: float = DEFAULT_TPC_LENGTH,
        tpc_radius: float = DEFAULT_TPC_RADIUS,
        nest_inst_types=None,
        seed=None,
) -> np.ndarray:
    """Uniform-in-volume, uniform-in-time S1+S2 instruction pairs with
    NEST(-like) quanta (wfsim_tpu instructions.py:77; reference:
    strax_interface.py:155-231).  The draws of ``np.random.default_rng(
    seed)`` come in wfsim_tpu's order."""
    rng = np.random.default_rng(seed)
    if nest_inst_types is None:
        nest_inst_types = [7]

    n_events = event_rate * chunk_size * n_chunk
    total_time = chunk_size * n_chunk

    inst = np.zeros(2 * n_events, dtype=instruction_dtype)
    uniform_times = total_time * (np.arange(n_events) + 0.5) / n_events
    inst['time'] = np.repeat(uniform_times, 2) * int(1e9)
    inst['event_number'] = np.digitize(
        inst['time'], 1e9 * np.arange(n_chunk) * chunk_size) - 1
    inst['type'] = np.tile([1, 2], n_events)

    r = np.sqrt(rng.uniform(0, tpc_radius ** 2, n_events))
    t = rng.uniform(-np.pi, np.pi, n_events)
    inst['x'] = np.repeat(r * np.cos(t), 2)
    inst['y'] = np.repeat(r * np.sin(t), 2)
    inst['z'] = np.repeat(rng.uniform(-tpc_length, 0, n_events), 2)
    inst['x_pri'], inst['y_pri'], inst['z_pri'] = inst['x'], inst['y'], inst['z']

    energy = rng.uniform(*energy_range, n_events)
    quanta, excitons, recoils, e_deps = [], [], [], []

    nest_calc = None
    if HAVE_NESTPY:
        nest_calc = nestpy.NESTcalc(nestpy.VDetector())
        density = 2.862  # g/cm^3
    for e_dep in energy:
        interaction_type = int(rng.choice(nest_inst_types))
        if nest_calc is not None:
            interaction = nestpy.INTERACTION_TYPE(interaction_type)
            y = nest_calc.GetYields(interaction, e_dep, density, drift_field,
                                    131.293, 54.)
            q = nest_calc.GetQuanta(y, density)
            n_ph, n_el, n_ex = q.photons, q.electrons, q.excitons
        else:
            n_ph, n_el, n_ex = analytic_yields(e_dep, drift_field,
                                               interaction_type, rng)
        quanta += [n_ph, n_el]
        excitons += [n_ex, 0]
        recoils += [interaction_type, interaction_type]
        e_deps += [e_dep, e_dep]

    inst['amp'] = quanta
    inst['local_field'] = drift_field
    inst['n_excitons'] = excitons
    inst['recoil'] = recoils
    inst['e_dep'] = e_deps
    # keep only non-degenerate instructions
    return inst[inst['amp'] > 0]


def instruction_from_csv(filename) -> np.ndarray:
    """Load instructions from CSV (reference: strax_interface.py:336-350);
    ``pandas`` is imported here, not with the package."""
    import pandas as pd
    df = pd.read_csv(filename)
    recs = np.zeros(len(df), dtype=instruction_dtype)
    for column in df.columns:
        recs[column] = df[column]
    return recs


def read_optical(config) -> ty.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GEANT4 optical-MC input: per-event photon channel/time lists from a
    ROOT file (wfsim_tpu instructions.py:166; reference:
    strax_interface.py:285-333).  Returns ``(instructions, channels,
    timings)``: type-1 instructions with ``_first`` / ``_last`` into the
    photon arrays, after :func:`~wfsim_tpu_torch.utils.optical_adjustment`.

    Uses ``uproot`` when importable, else the pure-python reader
    :mod:`wfsim_tpu_torch.resources.rootio`.  Sets ``config['entry_stop']``
    in place where it is None.  For the nVeto
    (``XENONnT_neutron_veto``) the photons are thinned by the PMT quantum
    efficiencies and the channels start at 0.
    """
    try:
        import uproot as rootlib
    except ImportError:
        from ..resources import rootio as rootlib

    from ..utils import optical_adjustment

    data = rootlib.open(config['fax_file'])
    try:
        events = data.get('events')
    except AttributeError:
        raise Exception('Are you using mc version >4?')

    g4id = events['eventid'].array(library='np')
    if config.get('entry_stop', None) is None:
        config['entry_stop'] = np.max(g4id) + 1
    mask = ((g4id < config.get('entry_stop', int(2 ** 63 - 1)))
            & (g4id >= config.get('entry_start', 0)))
    n_events = int(mask.sum())

    if config['detector'] == 'XENONnT_neutron_veto':
        channels, timings, amplitudes = _read_optical_nveto(config, events, mask)
        channels -= config['channel_map']['nveto'][0]
    else:
        channels = np.hstack(events['pmthitID'].array(library='np')[mask])
        timings = np.hstack(
            events['pmthitTime'].array(library='np')[mask] * 1e9).astype(np.int64)
        amplitudes = np.array([len(tmp) for tmp in
                               events['pmthitID'].array(library='np')[mask]])

    ins = np.zeros(n_events, dtype=instruction_dtype + optical_extra_dtype)
    ins['x'] = events['xp_pri'].array(library='np').flatten()[mask] / 10.
    ins['y'] = events['yp_pri'].array(library='np').flatten()[mask] / 10.
    ins['z'] = events['zp_pri'].array(library='np').flatten()[mask] / 10.
    ins['time'] = np.zeros(n_events, np.int64)
    ins['event_number'] = np.arange(n_events)
    ins['g4id'] = g4id[mask]
    ins['type'] = np.repeat(1, n_events)
    ins['recoil'] = np.repeat(1, n_events)
    ins['_first'] = np.cumsum(amplitudes) - amplitudes
    ins['_last'] = np.cumsum(amplitudes)
    ins = optical_adjustment(ins, timings, channels)
    return ins, channels, timings


def _read_optical_nveto(config, events, mask):
    """nVeto quantum-efficiency thinning of optical photons (wfsim_tpu
    instructions.py:226; reference: strax_interface.py:234-282): each
    photon is kept with its PMT's QE at its wavelength (times
    ``nv_pmt_ce_factor``), drawn with ``np.random.default_rng(seed)``."""
    from ..resources.loader import load_config as load_resource_config

    channels = np.hstack(events['pmthitID'].array(library='np')[mask])
    timings = np.hstack(
        events['pmthitTime'].array(library='np')[mask] * 1e9).astype(np.int64)
    constant_hc = 1239.841984
    wavelengths = np.hstack(
        constant_hc / events['pmthitEnergy'].array(library='np')[mask])

    nveto_channels = np.arange(config['channel_map']['nveto'][0],
                               config['channel_map']['nveto'][1] + 1)
    resource = load_resource_config(config)
    qe_data = getattr(resource, 'nv_pmt_qe', None)
    if qe_data is None:
        log.warning('nv pmt qe data not specified; all QEs default to 100%')
        wl_to_qe = np.ones([len(nveto_channels), 1000]) * 100
    else:
        wl_to_qe = np.zeros([len(nveto_channels), 1000])
        wl_axis = np.asarray(qe_data['nv_pmt_qe_wavelength'])
        for ich, channel in enumerate(nveto_channels):
            wl_to_qe[ich] = np.interp(np.arange(1000), wl_axis,
                                      np.asarray(qe_data['nv_pmt_qe'][str(channel)]),
                                      left=0, right=0)

    hit_mask = (channels >= nveto_channels[0]) & (channels <= nveto_channels[-1])
    channels_clipped = channels.copy()
    channels_clipped[~hit_mask] = nveto_channels[0]
    wavelengths[(wavelengths < 0) | (wavelengths >= 999)] = 0
    qes = wl_to_qe[channels_clipped - nveto_channels[0],
                   np.around(wavelengths).astype(np.int64)]
    rng = np.random.default_rng(config.get('seed') or None)
    hit_mask &= rng.random(len(qes)) <= qes * config.get('nv_pmt_ce_factor', 1.0) / 100

    amplitudes, offset = [], 0
    for tmp in events['pmthitID'].array(library='np')[mask]:
        n = len(tmp)
        amplitudes.append(hit_mask[offset:offset + n].sum())
        offset += n
    return (channels[hit_mask], timings[hit_mask],
            np.array(amplitudes, int))
