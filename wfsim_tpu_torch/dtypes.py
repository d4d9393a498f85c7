"""Data-model contracts: instruction, truth and raw-record dtypes.

These numpy structured dtypes define the framework's I/O boundary and are
bit-compatible with the reference simulator's contracts
(reference: wfsim/strax_interface.py:25-116) and with the strax
``raw_record`` data format, so downstream strax(en) processing can consume
our output unchanged.  They are plain numpy at the host boundary; all device
code uses unstructured arrays.
"""
import typing as ty

import numpy as np

__all__ = [
    'instruction_dtype', 'optical_extra_dtype', 'truth_extra_dtype',
    'extra_truth_dtype_per_pmt', 'raw_record_dtype', 'sort_by_time',
    'DEFAULT_RECORD_LENGTH', 'PULSE_TYPE_NAMES',
]

# Pulse type code -> name (reference: wfsim/core/rawdata.py:21)
PULSE_TYPE_NAMES = ('RESERVED', 's1', 's2', 'unknown', 'pi_el', 'pmt_ap', 'pe_el')

#: Number of waveform samples per raw record row (strax.DEFAULT_RECORD_LENGTH)
DEFAULT_RECORD_LENGTH = 110

# The per-energy-deposit simulation instruction
# (reference: wfsim/strax_interface.py:25-42)
instruction_dtype = [
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
]

# Extra index fields for optical (GEANT4 photon-list) input
# (reference: wfsim/strax_interface.py:45-46)
optical_extra_dtype = [
    (('first optical input index', '_first'), np.int32),
    (('last optical input index +1', '_last'), np.int32),
]

# Per-cluster truth summary (reference: wfsim/strax_interface.py:49-73)
truth_extra_dtype = [
    (('End time of the interaction [ns]', 'endtime'), np.int64),
    (('Number of simulated electrons', 'n_electron'), np.int32),
    (('Number of photons reaching PMT', 'n_photon'), np.int32),
    (('Number of photons + dpe passing', 'n_pe'), np.int32),
    (('Number of photons passing trigger', 'n_photon_trigger'), np.int32),
    (('Number of photons + dpe passing trigger', 'n_pe_trigger'), np.int32),
    (('Raw area in pe', 'raw_area'), np.float64),
    (('Raw area in pe passing trigger', 'raw_area_trigger'), np.float64),
    (('Number of photons reaching PMT (bottom)', 'n_photon_bottom'), np.int32),
    (('Number of photons + dpe passing (bottom)', 'n_pe_bottom'), np.int32),
    (('Number of photons passing trigger (bottom)', 'n_photon_trigger_bottom'), np.int32),
    (('Number of photons + dpe passing trigger (bottom)', 'n_pe_trigger_bottom'), np.int32),
    (('Raw area in pe (bottom)', 'raw_area_bottom'), np.float64),
    (('Raw area in pe passing trigger (bottom)', 'raw_area_trigger_bottom'), np.float64),
    (('Arrival time of the first photon [ns]', 't_first_photon'), np.float64),
    (('Arrival time of the last photon [ns]', 't_last_photon'), np.float64),
    (('Mean time of the photons [ns]', 't_mean_photon'), np.float64),
    (('Standard deviation of photon arrival times [ns]', 't_sigma_photon'), np.float64),
    (('X field-distorted mean position of the electrons [cm]', 'x_mean_electron'), np.float32),
    (('Y field-distorted mean position of the electrons [cm]', 'y_mean_electron'), np.float32),
    (('Arrival time of the first electron [ns]', 't_first_electron'), np.float64),
    (('Arrival time of the last electron [ns]', 't_last_electron'), np.float64),
    (('Mean time of the electrons [ns]', 't_mean_electron'), np.float64),
    (('Standard deviation of electron arrival times [ns]', 't_sigma_electron'), np.float64),
]


def extra_truth_dtype_per_pmt(n_pmt: ty.Union[bool, int]) -> ty.List[tuple]:
    """Truth dtype, optionally with per-PMT count/area vectors.

    When ``n_pmt`` is falsy, returns the total/bottom split of
    :data:`truth_extra_dtype`; otherwise per-PMT vector fields
    (reference: wfsim/strax_interface.py:76-116).
    """
    if not n_pmt:
        return truth_extra_dtype
    return [
        (('End time of the interaction [ns]', 'endtime'), np.int64),
        (('Number of simulated electrons', 'n_electron'), np.int32),
        # Per-PMT fields
        (('Number of photons reaching PMT', 'n_photon_per_pmt'), (np.int32, n_pmt)),
        (('Number of photons + dpe passing', 'n_pe_per_pmt'), (np.int32, n_pmt)),
        (('Number of photons passing trigger', 'n_photon_trigger_per_pmt'), (np.int32, n_pmt)),
        (('Number of photons + dpe passing trigger', 'n_pe_trigger_per_pmt'), (np.int32, n_pmt)),
        (('Raw area in pe', 'raw_area_per_pmt'), (np.float64, n_pmt)),
        (('Raw area in pe passing trigger', 'raw_area_trigger_per_pmt'), (np.float64, n_pmt)),
        # Aggregate (total) fields
        (('Number of photons reaching PMT (total)', 'n_photon'), np.int32),
        (('Number of photons + dpe passing (total)', 'n_pe'), np.int32),
        (('Number of photons passing trigger (total)', 'n_photon_trigger'), np.int32),
        (('Number of photons + dpe passing trigger (total)', 'n_pe_trigger'), np.int32),
        (('Raw area in pe (total)', 'raw_area'), np.float64),
        (('Raw area in pe passing trigger (total)', 'raw_area_trigger'), np.float64),
        # General fields
        (('Arrival time of the first photon [ns]', 't_first_photon'), np.float64),
        (('Arrival time of the last photon [ns]', 't_last_photon'), np.float64),
        (('Mean time of the photons [ns]', 't_mean_photon'), np.float64),
        (('Standard deviation of photon arrival times [ns]', 't_sigma_photon'), np.float64),
        (('X field-distorted mean position of the electrons [cm]', 'x_mean_electron'), np.float32),
        (('Y field-distorted mean position of the electrons [cm]', 'y_mean_electron'), np.float32),
        (('Arrival time of the first electron [ns]', 't_first_electron'), np.float64),
        (('Arrival time of the last electron [ns]', 't_last_electron'), np.float64),
        (('Mean time of the electrons [ns]', 't_mean_electron'), np.float64),
        (('Standard deviation of electron arrival times [ns]', 't_sigma_electron'), np.float64),
    ]


def raw_record_dtype(samples_per_record: int = DEFAULT_RECORD_LENGTH):
    """strax-compatible raw_record dtype (bit-compatible with
    ``strax.raw_record_dtype``, used by the reference at
    wfsim/strax_interface.py:360-361)."""
    return [
        (('Start time since unix epoch [ns]', 'time'), np.int64),
        (('Length of the interval in samples', 'length'), np.int32),
        (('Width of one sample [ns]', 'dt'), np.int16),
        (('Channel/PMT number', 'channel'), np.int16),
        (('Length of pulse to which the record belongs (without zero-padding)',
          'pulse_length'), np.int32),
        (('Fragment number in the pulse', 'record_i'), np.int16),
        (('Baseline determined by the digitizer (if this is supported)',
          'baseline'), np.int16),
        (('Waveform data in raw ADC counts', 'data'), np.int16, samples_per_record),
    ]


def concat_records(parts) -> np.ndarray:
    """Concatenate structured record arrays through a raw-byte view.

    np.concatenate takes a slow path for dtypes with subarray fields like
    raw_record's (110,)-int16 data; byte-view block copies run at memcpy
    speed.
    """
    parts = [p for p in parts if len(p)]
    if not parts:
        raise ValueError('concat_records needs at least one non-empty part '
                         '(callers handle the empty case)')
    if len(parts) == 1:
        return parts[0]
    dtype = parts[0].dtype
    isz = dtype.itemsize

    # zero-copy fast path: consecutive views of one base array (the
    # digitize host split fills one chunk-level array in stream order)
    try:
        from numpy.lib.array_utils import byte_bounds as _bb
    except ImportError:  # numpy < 2
        _bb = np.byte_bounds
    base = parts[0].base
    if base is not None and isinstance(base, np.ndarray) \
            and base.dtype == dtype and base.ndim == 1 \
            and all(p.base is base for p in parts):
        lo0 = _bb(parts[0])[0]
        prev_hi = lo0
        ok = True
        for p in parts:
            lo, hi = _bb(p)
            # byte-bounds adjacency alone would accept strided views (e.g.
            # base[0:10:2] then base[9:]); require each part to be a dense
            # contiguous run so the returned base slice is value-identical
            if lo != prev_hi or not p.flags['C_CONTIGUOUS'] \
                    or hi - lo != len(p) * isz:
                ok = False
                break
            prev_hi = hi
        if ok:
            start = (lo0 - _bb(base)[0]) // isz
            n = sum(len(p) for p in parts)
            return base[start:start + n]
    out = np.empty(sum(len(p) for p in parts), dtype)
    ob = out.view(np.uint8)
    o = 0
    for p in parts:
        n = len(p) * isz
        ob[o:o + n] = np.ascontiguousarray(p).view(np.uint8).reshape(-1)
        o += n
    return out


def sort_by_time(records: np.ndarray) -> np.ndarray:
    """Stable sort of structured records by (time, channel) like strax does.
    Single lexsort + single gather (structured-array copies are expensive)."""
    if len(records) == 0:
        return records
    if 'channel' in records.dtype.names:
        order = np.lexsort((records['channel'], records['time']))
    else:
        order = np.argsort(records['time'], kind='stable')
    return records[order]
