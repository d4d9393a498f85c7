"""Resource resolution for the port: config -> in-memory detector assets.

Counterpart of ``wfsim_tpu/resources/loader.py``, cut to the path that
``default_config()`` reaches (``Resource`` construction with
``['constant dummy', value, shape]`` map entries and the synthetic SPE
table, wfsim_tpu/resources/loader.py:368-575).  Every map is a
:class:`~wfsim_tpu_torch.ops.interp.GridMap` of host float32 arrays; the
device copy is made by ``models.params.build_params``.

Not ported yet (each raises ``NotImplementedError``): real map files
(straxen InterpolatingMap JSON, npz, pickle), field-distortion maps,
field-dependency maps, gas-gap maps, luminescence tables, optical
propagation splines, afterpulse tables and the noise bank.
"""
from __future__ import annotations

import numpy as np

from ..ops.interp import GridMap
from .spe import build_uniform_to_pe
from . import synthetic as synth

__all__ = ['Resource', 'load_config', 'make_map', 'DummyMap']


def load_config(config) -> 'Resource':
    """Resource factory (same name as wfsim_tpu.resources.load_config).
    Building the dummy-map resource takes milliseconds, so no cache."""
    return Resource(config)


class DummyMap:
    """Constant map entry (the reference's DummyMap,
    wfsim/load_resource.py:437-457); ``as_gridmap`` makes its device form."""

    def __init__(self, const, shape=()):
        self.const = const
        self.shape = tuple(shape)

    def reduce_last_dim(self):
        if len(self.shape) < 1:
            raise ValueError('Need at least 1 dim to reduce further')
        const = self.const * self.shape[-1]
        shape = list(self.shape)
        shape[-1] = 1
        return DummyMap(const, shape)


def make_map(entry):
    """Resolve one config map entry: dummy list or None."""
    if entry is None or entry is False or entry == '':
        return None
    if isinstance(entry, list) and entry and entry[0] == 'constant dummy':
        return DummyMap(entry[1], entry[2] if len(entry) > 2 else ())
    if isinstance(entry, str):
        raise NotImplementedError(
            f'map file {entry!r}: the port reads only ["constant dummy", '
            f'value, shape] map entries so far')
    raise TypeError(f"Can't handle map entry {entry!r}")


def as_gridmap(m, ndim_in=2):
    """DummyMap / None -> GridMap / None (wfsim_tpu loader ``_as_gridmap``)."""
    if m is None:
        return None
    want = int(np.prod(m.shape)) if m.shape else 1
    return GridMap.constant(m.const, out_dim=max(want, 1), ndim_in=ndim_in)


_UNSUPPORTED = (
    ('field_distortion_model', lambda v: v not in (None, 'none'),
     'field distortion maps'),
    ('enable_gas_gap_warping', bool, 'gas-gap map'),
    ('enable_pmt_afterpulses', bool, 'PMT afterpulse tables'),
    ('enable_electron_afterpulses', bool, 'electron afterpulse tables'),
    ('enable_noise', bool, 'noise bank'),
    ('photon_area_distribution', lambda v: isinstance(v, str),
     'measured SPE spectrum file'),
    ('s1_time_spline', bool, 'S1 optical propagation spline'),
    ('s2_time_spline', bool, 'S2 optical propagation spline'),
    ('s2_luminescence_model', lambda v: v != 'simple',
     'garfield luminescence tables'),
    ('enable_field_dependencies',
     lambda v: isinstance(v, dict) and any(bool(x) for x in v.values()),
     'field-dependency maps'),
)


class Resource:
    """All in-memory assets for one configuration (dummy-map path of
    wfsim_tpu.resources.loader.Resource)."""

    def __init__(self, config):
        for key, bad, what in _UNSUPPORTED:
            if bad(config.get(key)):
                raise NotImplementedError(
                    f'{key}={config.get(key)!r} needs the {what}, which the '
                    f'port does not load yet')
        n_pmts = int(config['n_tpc_pmts'])

        self.s1_pattern_map = make_map(config.get('s1_pattern_map'))
        self.s2_pattern_map = make_map(config.get('s2_pattern_map'))
        self.se_gain_map = make_map(config.get('se_gain_map'))

        # S1 LCE: sum of the pattern map (reference: load_resource.py:243-250)
        lce = config.get('s1_lce_correction_map')
        if lce:
            self.s1_lce_correction_map = make_map(lce)
        else:
            self.s1_lce_correction_map = self.s1_pattern_map.reduce_last_dim()

        # S2 AFT rescale (reference: load_resource.py:252-267) leaves a
        # dummy pattern map untouched, as wfsim_tpu does
        s2c = config.get('s2_correction_map')
        if s2c:
            self.s2_correction_map = make_map(s2c)
        else:
            self.s2_correction_map = self.s2_pattern_map.reduce_last_dim()

        charge, pdfs = synth.synthetic_spe_distribution(n_pmts)
        self.uniform_to_pe = build_uniform_to_pe(charge, pdfs)
