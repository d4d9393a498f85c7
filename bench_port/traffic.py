"""Traffic: instruction streams drawn from a mix file and ``--seed``.

A mix (``traffic/<mix>.json``) holds the parameters of the upstream random
generator (XENONnT/WFSim ``strax_interface.py:138-231 rand_instructions``):
S1+S2 instruction pairs, uniform in the TPC volume, evenly spread in time
at ``event_rate_hz``, with energies uniform in ``energy_kev`` and the
recoil types of ``recoil_types``.  The quanta rule is the mix's own
(``quanta``): total quanta ``E / w_kev`` (truncated), ``electron_fraction``
of them electrons (truncated), the rest photons.

The generator is a frozen copy of the program's ``_rand_instructions``
(``wfsim_tpu_torch/interface/instructions.py``), with the per-event NEST
(or analytic) yields replaced by the mix's quanta rule and the draws made
array-wise: positions, then energies, then recoil types, all from
``numpy.random.default_rng(seed)``.  It imports nothing of the program.

With ``stratified_block`` B, the squared radius, the depth and the energy
are stratified: each block of B consecutive events takes the midpoints of
B equal strata of each range, each quantity in its own random order.
Every seed then sends the same set of events in another order, and each
block of B events (about a super-batch) carries the same load; the
azimuth stays a free uniform draw.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
TRAFFIC_DIR = HERE / 'traffic'

#: the instruction dtype of strax / WFSim (field order and widths)
INSTRUCTION_DTYPE = np.dtype([
    (('Waveform simulator event number.', 'event_number'), np.int32),
    (('Quanta type (S1 photons or S2 electrons)', 'type'), np.int8),
    (('Time of the interaction [ns]', 'time'), np.int64),
    (('X position of the cluster [cm]', 'x'), np.float32),
    (('Y position of the cluster [cm]', 'y'), np.float32),
    (('Z position of the cluster [cm]', 'z'), np.float32),
    (('Number of quanta', 'amp'), np.int32),
    (('Recoil type of interaction.', 'recoil'), np.int8),
    (('Energy deposit of interaction', 'e_dep'), np.float32),
    (('Total energy deposit in the sensitive volume', 'tot_e'), np.float32),
    (('Eventid like in geant4 output rootfile', 'g4id'), np.int32),
    (('Volume id giving the detector subvolume', 'vol_id'), np.int32),
    (('Local field [ V / cm ]', 'local_field'), np.float64),
    (('Number of excitons', 'n_excitons'), np.int32),
    (('X position of the primary particle [cm]', 'x_pri'), np.float32),
    (('Y position of the primary particle [cm]', 'y_pri'), np.float32),
    (('Z position of the primary particle [cm]', 'z_pri'), np.float32),
])


def load_mix(name: str) -> dict:
    """The mix file ``traffic/<name>.json``."""
    path = TRAFFIC_DIR / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no traffic mix {name!r} ({path})')
    return json.loads(path.read_text())


def quanta(energy_kev: np.ndarray, rule: dict):
    """(photons, electrons) per deposit under the mix's quanta rule."""
    total = np.floor(energy_kev / float(rule['w_kev'])).astype(np.int64)
    electrons = np.floor(total * float(rule['electron_fraction'])).astype(
        np.int64)
    return total - electrons, electrons


def instructions(mix: dict, seed: int, *, tpc_radius: float,
                 tpc_length: float, drift_field: float,
                 n_events: int | None = None) -> np.ndarray:
    """The mix's instruction stream for ``seed`` (S1 then S2 of each event,
    in time order); ``n_events`` overrides the mix's count (tests)."""
    n = int(mix['n_events'] if n_events is None else n_events)
    rate = float(mix['event_rate_hz'])
    chunk_s = float(mix['generator_chunk_s'])
    rng = np.random.default_rng(int(seed))

    inst = np.zeros(2 * n, dtype=INSTRUCTION_DTYPE)
    total_time = n / rate
    uniform_times = total_time * (np.arange(n) + 0.5) / n
    inst['time'] = (np.repeat(uniform_times, 2) * 1e9).astype(np.int64)
    # the upstream event number: the generator chunk the event falls in
    inst['event_number'] = np.digitize(
        inst['time'], 1e9 * np.arange(int(np.ceil(total_time / chunk_s)))
        * chunk_s) - 1
    inst['type'] = np.tile([1, 2], n)

    block = mix.get('stratified_block')
    if block:
        def uniform(lo, hi, size):
            n_blocks = -(-size // block)
            ranks = np.argsort(rng.random((n_blocks, block)), axis=1)
            u = ((ranks + 0.5) / block).reshape(-1)[:size]
            return lo + (hi - lo) * u
    else:
        uniform = rng.uniform

    r = np.sqrt(uniform(0, tpc_radius ** 2, n))
    th = rng.uniform(-np.pi, np.pi, n)
    inst['x'] = np.repeat(r * np.cos(th), 2)
    inst['y'] = np.repeat(r * np.sin(th), 2)
    inst['z'] = np.repeat(uniform(-tpc_length, 0, n), 2)
    inst['x_pri'], inst['y_pri'], inst['z_pri'] = \
        inst['x'], inst['y'], inst['z']

    lo, hi = mix['energy_kev']
    energy = uniform(lo, hi, n)
    recoil = rng.choice(np.asarray(mix['recoil_types']), n)
    photons, electrons = quanta(energy, mix['quanta'])
    amp = np.empty(2 * n, np.int64)
    amp[0::2], amp[1::2] = photons, electrons
    inst['amp'] = amp
    inst['local_field'] = drift_field
    inst['recoil'] = np.repeat(recoil, 2)
    inst['e_dep'] = np.repeat(energy, 2)
    return inst[inst['amp'] > 0]
