"""Standalone simulator front end (counterpart of
wfsim_tpu/interface/simulator.py; reference: wfsim/strax_interface.py:506-714).

Config resolution, instruction checks and chunked iteration over
``ChunkRawRecords`` on one device: the card (``'cuda'``) unless the caller
asks for another; construction raises where there is no card.  With
``mesh`` (``parallel.make_mesh``) the run is shared over the mesh's
``'events'`` dim: every rank calls it with the same instructions and
returns the arrays of the single-device run.  Without an instruction
array the run takes them from ``fax_file`` (a csv file) or, where it is
unset, from ``rand_instructions(config)``.
"""
from __future__ import annotations

import logging
import typing as ty

import numpy as np

from ..config import default_config, finalize_config, load_fax_config
from ..dtypes import concat_records
from ..pipeline.chunker import ChunkRawRecords
from ..pipeline.rawdata import resolve_device
from .instructions import rand_instructions, instruction_from_csv

log = logging.getLogger('wfsim_tpu_torch.interface')

__all__ = ['Simulator', 'check_instructions']


def check_instructions(instructions: np.ndarray, config) -> np.ndarray:
    """The instructions without below-cathode S2s (below-cathode S1s
    pass); raises ``ValueError`` where an interaction lies outside the TPC
    or has zero size (reference: strax_interface.py:674-693)."""
    m = ((instructions['z'] < -config['tpc_length'])
         & (instructions['type'] == 2))
    instructions = instructions[~m]
    r = np.sqrt(instructions['x'] ** 2 + instructions['y'] ** 2)
    if not np.all((r < config['tpc_radius'])
                  | np.isclose(r, config['tpc_radius'])):
        raise ValueError('Interaction is outside the TPC (radius)')
    if not np.all(instructions['z'] < 0.25):
        raise ValueError('Interaction is outside the TPC (in Z)')
    if not np.all(instructions['amp'] > 0):
        raise ValueError('Interaction has zero size')
    return instructions


class Simulator:
    """instructions -> iterator of {raw_records*, truth} chunk dicts.

    Usage::

        sim = Simulator(default_config(seed=1))        # on the card
        out = sim.get_arrays(instructions)
        Simulator(default_config(seed=1), device='cpu')  # the plain twins
        # every rank of an initialised process group, one card each:
        Simulator(default_config(seed=1), mesh=make_mesh())
    """

    def __init__(self, config: ty.Optional[dict] = None,
                 fax_config: ty.Optional[str] = None,
                 fax_config_override: ty.Optional[dict] = None,
                 *, device='cuda', mesh=None, **overrides):
        config = default_config() if config is None else dict(config)
        if fax_config:
            config.update(load_fax_config(fax_config))
        if fax_config_override:
            config.update(fax_config_override)
        config.update(overrides)
        self.config = finalize_config(config)
        self.device = resolve_device(device)
        self.sim = ChunkRawRecords(self.config, device=self.device,
                                   mesh=mesh)

    # -- instruction handling (reference: strax_interface.py:674-693) -------

    def get_instructions(self) -> np.ndarray:
        """The csv file ``fax_file``, else random instructions from the
        config (wfsim_tpu simulator.py:61-68)."""
        fax_file = self.config.get('fax_file')
        if fax_file:
            if str(fax_file).endswith('root'):
                raise ValueError('Non-optical G4 input is deprecated, use '
                                 'epix instructions')
            if not str(fax_file).endswith('csv'):
                raise ValueError('Only csv input is supported')
            return instruction_from_csv(fax_file)
        return rand_instructions(self.config)

    def check_instructions(self, instructions: np.ndarray) -> np.ndarray:
        return check_instructions(instructions, self.config)

    # -- execution ------------------------------------------------------------

    def run(self, instructions: ty.Optional[np.ndarray] = None,
            time_zero: ty.Optional[int] = None):
        """Yield chunk dicts; enforces the reference's stream invariants
        (sortedness, >=1 us chunk spacing; strax_interface.py:622-640).
        Without ``instructions``, :meth:`get_instructions` gives them."""
        if instructions is None:
            instructions = self.get_instructions()
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

    def get_arrays(self, instructions: ty.Optional[np.ndarray] = None):
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
