"""Lightweight pax-compatible event data model (legacy XENON1T output; a
copy of wfsim_tpu/pax_datastructure.py, so the pickles and dicts match).

The reference vendors pax's full typed data model
(reference: wfsim/pax_datastructure/datastructure.py: Event :596, Pulse :425,
Peak :179, Hit :83, plus the StrictModel machinery in data_model.py).  Only
``Event`` and ``Pulse`` are ever instantiated by the simulator's pax output
path (pax_interface.py:46-60), so this module provides those with the same
field names and init-time type coercion, plus minimal stand-ins for the rest
of the hierarchy so downstream pickles have the expected attribute surface.
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ['Model', 'Pulse', 'Hit', 'Peak', 'SumWaveform',
           'ReconstructedPosition', 'Interaction', 'TriggerSignal', 'Event']


class Model:
    """Typed record: class attributes declare fields and defaults; kwargs are
    coerced to the default's type at init (the behaviour wfsim relies on from
    pax's StrictModel)."""

    def __init__(self, **kwargs):
        for name in self._fields():
            default = getattr(type(self), name)
            setattr(self, name, self._coerce(default, kwargs.pop(name, default)))
        if kwargs:
            raise ValueError(f'Unknown fields for {type(self).__name__}: '
                             f'{sorted(kwargs)}')

    @classmethod
    def _fields(cls):
        return [k for k in dir(cls)
                if not k.startswith('_')
                and not callable(getattr(cls, k))
                and not isinstance(getattr(cls, k), property)]

    @staticmethod
    def _coerce(default, value):
        if isinstance(default, (int, np.integer)) and not isinstance(default, bool):
            return int(value)
        if isinstance(default, float):
            return float(value)
        if isinstance(default, np.ndarray) and not isinstance(value, np.ndarray):
            return np.asarray(value, dtype=default.dtype)
        return value

    def _child_lists(self):
        """Names of list-of-Model attributes (set by subclasses like Event)."""
        return [k for k, v in vars(self).items()
                if isinstance(v, list) and not k.startswith('_')]

    def to_dict(self, convert_numpy_arrays_to=None, fields_to_ignore=()):
        """Recursive dict form, like pax's Model.to_dict
        (reference: wfsim/pax_datastructure/data_model.py:60-120).
        ``convert_numpy_arrays_to``: None keeps ndarrays, 'list' converts.
        """
        def conv(v):
            if isinstance(v, Model):
                return v.to_dict(convert_numpy_arrays_to, fields_to_ignore)
            if isinstance(v, list):
                return [conv(x) for x in v]
            if isinstance(v, np.ndarray):
                return v.tolist() if convert_numpy_arrays_to == 'list' else v
            if isinstance(v, np.generic):
                return v.item()
            return v
        out = {}
        for k in self._fields() + self._child_lists():
            if k in fields_to_ignore:
                continue
            out[k] = conv(getattr(self, k))
        return out

    def to_json(self, fields_to_ignore=()):
        """JSON form (pax: data_model.py:122-130); ndarrays become lists."""
        return json.dumps(self.to_dict(convert_numpy_arrays_to='list',
                                       fields_to_ignore=fields_to_ignore))

    def __repr__(self):
        return f'{type(self).__name__}({self.to_dict()})'


class Pulse(Model):
    """An individual digitizer pulse (zero-length-encoded occurrence)."""
    channel = 0
    left = 0
    right = 0
    raw_data = np.zeros(0, dtype=np.int16)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.right == 0 and len(self.raw_data):
            self.right = self.left + len(self.raw_data) - 1

    @property
    def length(self):
        return self.right - self.left + 1


class Hit(Model):
    channel = 0
    left = 0
    right = 0
    area = 0.0
    height = 0.0
    center = 0.0
    found_in_pulse = 0


class ReconstructedPosition(Model):
    x = 0.0
    y = 0.0
    z = 0.0
    algorithm = 'none'


class SumWaveform(Model):
    name = 'tpc'
    detector = 'tpc'
    samples = np.zeros(0, dtype=np.float32)


class Peak(Model):
    area = 0.0
    left = 0
    right = 0
    type = 'unknown'
    detector = 'tpc'
    area_per_channel = np.zeros(0, dtype=np.float64)


class Interaction(Model):
    x = 0.0
    y = 0.0
    z = 0.0
    drift_time = 0.0


class TriggerSignal(Model):
    left_time = 0
    right_time = 0
    time_mean = 0.0
    n_pulses = 0
    type = 0
    trigger = False


class Event(Model):
    """pax Event: the container the pax output path pickles per event."""
    event_number = 0
    block_id = -1
    dataset_name = 'wfsim_tpu'
    start_time = 0
    stop_time = 0
    sample_duration = 10
    n_channels = 0

    def __init__(self, n_channels=0, start_time=0, sample_duration=10,
                 stop_time=0, partial=False, **kwargs):
        self.pulses = kwargs.pop('pulses', [])
        self.hits = kwargs.pop('hits', [])
        self.peaks = kwargs.pop('peaks', [])
        self.sum_waveforms = kwargs.pop('sum_waveforms', [])
        self.interactions = kwargs.pop('interactions', [])
        self.trigger_signals = kwargs.pop('trigger_signals', [])
        super().__init__(n_channels=n_channels, start_time=start_time,
                         sample_duration=sample_duration, stop_time=stop_time,
                         **kwargs)

    def duration(self):
        return self.stop_time - self.start_time

    def length(self):
        return int(self.duration() // self.sample_duration)
