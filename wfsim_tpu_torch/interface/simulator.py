"""Standalone simulator front end (counterpart of
wfsim_tpu/interface/simulator.py; reference: wfsim/strax_interface.py:506-714).

Config resolution, instruction checks and chunked iteration over
``ChunkRawRecords``, with the device every tensor lives on passed
explicitly.  Generating instructions (``rand_instructions``, csv input) is
not ported: pass the instruction array.
"""
from __future__ import annotations

import logging
import typing as ty

import numpy as np
import torch

from ..config import default_config, finalize_config, load_fax_config
from ..dtypes import concat_records
from ..pipeline.chunker import ChunkRawRecords

log = logging.getLogger('wfsim_tpu_torch.interface')

__all__ = ['Simulator']


class Simulator:
    """instructions -> iterator of {raw_records*, truth} chunk dicts.

    Usage::

        sim = Simulator(default_config(seed=1), device=torch.device('cuda'))
        out = sim.get_arrays(instructions)
    """

    def __init__(self, config: ty.Optional[dict] = None,
                 fax_config: ty.Optional[str] = None,
                 fax_config_override: ty.Optional[dict] = None,
                 *, device, **overrides):
        config = default_config() if config is None else dict(config)
        if fax_config:
            config.update(load_fax_config(fax_config))
        if fax_config_override:
            config.update(fax_config_override)
        config.update(overrides)
        self.config = finalize_config(config)
        self.device = torch.device(device)
        self.sim = ChunkRawRecords(self.config, device=self.device)

    # -- instruction handling (reference: strax_interface.py:674-693) -------

    def check_instructions(self, instructions: np.ndarray) -> np.ndarray:
        # Let below-cathode S1s pass but remove below-cathode S2s
        m = ((instructions['z'] < -self.config['tpc_length'])
             & (instructions['type'] == 2))
        instructions = instructions[~m]
        r = np.sqrt(instructions['x'] ** 2 + instructions['y'] ** 2)
        if not np.all((r < self.config['tpc_radius'])
                      | np.isclose(r, self.config['tpc_radius'])):
            raise ValueError('Interaction is outside the TPC (radius)')
        if not np.all(instructions['z'] < 0.25):
            raise ValueError('Interaction is outside the TPC (in Z)')
        if not np.all(instructions['amp'] > 0):
            raise ValueError('Interaction has zero size')
        return instructions

    # -- execution ------------------------------------------------------------

    def run(self, instructions: np.ndarray, time_zero: ty.Optional[int] = None):
        """Yield chunk dicts; enforces the reference's stream invariants
        (sortedness, >=1 us chunk spacing; strax_interface.py:622-640)."""
        instructions = self.check_instructions(np.asarray(instructions))
        last_chunk_time = -999_999_999_999_999
        for result in self.sim(instructions, time_zero=time_zero):
            rr = result.get('raw_records')
            if rr is not None and len(rr):
                if rr['time'][0] < last_chunk_time + 1000:
                    raise RuntimeError(
                        'Simulator returned chunks with insufficient spacing')
                if len(rr) > 1 and np.diff(rr['time']).min() < 0:
                    raise RuntimeError('Simulator returned non-sorted records')
                last_chunk_time = max(int(rr['time'].max()), last_chunk_time)
            result['start'] = int(self.sim.chunk_time_pre)
            result['end'] = int(self.sim.chunk_time)
            yield result

    def get_arrays(self, instructions: np.ndarray):
        """Run to completion and concatenate all chunks."""
        outs: ty.Dict[str, list] = {}
        for chunk in self.run(instructions):
            for k, v in chunk.items():
                if isinstance(v, np.ndarray):
                    outs.setdefault(k, []).append(v)

        def cat(v):
            if len(v) == 1:
                return v[0]
            if any(len(x) for x in v):
                return concat_records(v)
            return v[0]
        return {k: cat(v) for k, v in outs.items()}

    def source_finished(self):
        return self.sim.source_finished()
