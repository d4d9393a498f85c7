"""Legacy pax output path (XENON1T era; counterpart of
wfsim_tpu/interface/pax.py, reference: wfsim/pax_interface.py:22-202).

Wraps the legacy pulses of :meth:`RawData.__call__
<wfsim_tpu_torch.pipeline.rawdata.RawData.__call__>` into pax ``Event``
objects per instruction event, pickles + zlib-compresses them into zip
archives of ``events_per_file`` events, and writes the truth as CSV
(``pandas`` is imported by :meth:`PaxEventSimulator.compute`, not with the
package).  The simulation runs on ``device``: the card unless the caller
asks for another.
"""
from __future__ import annotations

import os
import pickle
import zipfile
import zlib
from collections import namedtuple

import numpy as np

from ..config import default_config as _default_tpu_config, finalize_config
from ..dtypes import instruction_dtype, truth_extra_dtype
from ..pipeline.rawdata import RawData
from ..pax_datastructure import Event, Pulse
from .instructions import rand_instructions, instruction_from_csv

__all__ = ['PaxEvents', 'PaxEventSimulator', 'pax_default_config']

EventProxy = namedtuple('EventProxy', ['data', 'event_number', 'block_id'])

pax_default_config = {
    'fax_file': None,
    'detector': 'XENON1T',
    'event_rate': 1,      # one event per chunk
    'chunk_size': 1,
    'n_chunk': 200,
    'samples_to_store_before': 2,
    'samples_to_store_after': 20,
    'right_raw_extension': 50000,
    'trigger_window': 50,
    'zle_threshold': 0,
    'run_number': 10000,
    'events_per_file': 1000,
    'output_name': './pax_data',
}


class PaxEvents:
    """Group raw-data pulses into pax Events by instruction event number
    (reference: pax_interface.py:22-60)."""

    def __init__(self, config, *, device='cuda'):
        self.config = config
        self.rawdata = RawData(config, device=device)
        self.truth_buffer = np.zeros(
            100000, dtype=instruction_dtype + truth_extra_dtype
            + [('fill', bool)])

    def __call__(self, instructions):
        event = None
        first_left = None
        last_right = -np.inf
        n_channels = self.config.get('n_channels',
                                     self.config.get('n_tpc_pmts', 248))
        dt = self.config['sample_duration']

        for channel, left, right, data in self.rawdata(
                instructions, self.truth_buffer):
            event_number = self.rawdata.instruction_event_number
            if event is not None and event_number > event.event_number:
                event.start_time = int((first_left - 100000) * dt)
                event.stop_time = int((last_right + 100000) * dt)
                yield event
                event = None

            if event is None:
                event = Event(event_number=event_number,
                              start_time=0,
                              stop_time=int(3e6),
                              n_channels=n_channels,
                              sample_duration=dt,
                              pulses=[])
                first_left = left

            last_right = max(last_right, right)
            event.pulses.append(Pulse(
                channel=int(channel),
                left=int(left - (first_left - 100000)),
                raw_data=np.asarray(data, dtype=np.int16)))

        if event is not None:
            event.start_time = int((first_left - 100000) * dt)
            event.stop_time = int((last_right + 100000) * dt)
            yield event


class PaxEventSimulator:
    """Simulate events into pax-style zip archives
    (reference: pax_interface.py:87-202)."""

    def __init__(self, config=None, *, device='cuda'):
        self.config = dict(pax_default_config)
        base = _default_tpu_config(detector=self.config['detector'])
        merged = dict(base)
        merged.update(self.config)
        if config:
            merged.update(config)
        self.config = finalize_config(merged)

        if self.config['fax_file']:
            self.instructions = instruction_from_csv(self.config['fax_file'])
        else:
            self.instructions = rand_instructions(self.config)

        self.pax_event = PaxEvents(self.config, device=device)
        self.transfer_plugin = self.WriteZippedEncoder(self.config)
        self.output_plugin = self.WriteZipped(self.config)

    class WriteZippedEncoder:
        def __init__(self, config):
            self.config = config

        @staticmethod
        def make_event_proxy(event, data, block_id=None):
            if block_id is None:
                block_id = event.block_id
            return EventProxy(data=data, event_number=event.event_number,
                              block_id=block_id)

        def transfer_event(self, event):
            data = zlib.compress(pickle.dumps(event), 4)
            return self.make_event_proxy(
                event, data=dict(blob=data, start_time=event.start_time,
                                 stop_time=event.stop_time))

    class WriteZipped:
        file_extension = 'zip'

        def __init__(self, config):
            self.config = config
            self.events_per_file = config.get('events_per_file', 50)
            self.first_event_in_current_file = None
            self.last_event_written = None
            self.output_dir = os.path.join(
                config['output_name'],
                '%s_MC_%d' % (config['detector'], config['run_number']))
            os.makedirs(self.output_dir, exist_ok=True)
            self.tempfile = os.path.join(self.output_dir,
                                         'temp.' + self.file_extension)

        def open_new_file(self, first_event_number):
            if self.last_event_written is not None:
                self.close_current_file()
            self.first_event_in_current_file = first_event_number
            self.events_written_to_current_file = 0
            self.current_file = zipfile.ZipFile(self.tempfile, mode='w')

        def write_event(self, event_proxy):
            if (self.last_event_written is None
                    or self.events_written_to_current_file
                    >= self.events_per_file):
                self.open_new_file(event_proxy.event_number)
            self.current_file.writestr(str(event_proxy.event_number),
                                       event_proxy.data['blob'])
            self.events_written_to_current_file += 1
            self.last_event_written = event_proxy.event_number

        def close_current_file(self):
            if self.last_event_written is None:
                return
            self.current_file.close()
            os.rename(self.tempfile, os.path.join(
                self.output_dir,
                '%s-%d-%09d-%09d-%09d.%s' % (
                    self.config['detector'], self.config['run_number'],
                    self.first_event_in_current_file,
                    self.last_event_written,
                    self.events_written_to_current_file,
                    self.file_extension)))

    def compute(self):
        import pandas as pd
        for event in self.pax_event(self.instructions):
            proxy = self.transfer_plugin.transfer_event(event)
            self.output_plugin.write_event(proxy)
        self.output_plugin.close_current_file()

        truth_path = os.path.join(
            self.output_plugin.output_dir,
            '%s-%d-truth.csv' % (self.config['detector'],
                                 self.config['run_number']))
        filled = self.pax_event.truth_buffer[self.pax_event.truth_buffer['fill']]
        truth = pd.DataFrame(filled)
        truth.drop(columns='fill', inplace=True)
        truth.to_csv(truth_path, index=False)
