"""Chunked record emission (host numpy, copied from
wfsim_tpu/pipeline/chunker.py with the port's RawData).

Behavioural equivalent of the reference ``ChunkRawRecords``
(reference: wfsim/strax_interface.py:353-504): consume (channel, left, right,
data) pulses from the raw-data generator, pack them into fixed-length
raw_record rows, cut chunks at time boundaries with event-aware extension,
and drain the truth buffer per chunk.
"""
from __future__ import annotations

import logging
import time as _time
import typing as ty

import numpy as np

from ..config import finalize_config
from ..dtypes import (raw_record_dtype, instruction_dtype,
                      extra_truth_dtype_per_pmt, sort_by_time,
                      concat_records, DEFAULT_RECORD_LENGTH)
from .arena import RecordArena
from .rawdata import RawData

log = logging.getLogger('wfsim_tpu_torch.interface')

__all__ = ['ChunkRawRecords']


class ChunkRawRecords:
    def __init__(self, config, *, device='cuda', mesh=None,
                 rawdata_generator=RawData, **kwargs):
        self.config = finalize_config(dict(config))
        self.rawdata = rawdata_generator(self.config, device=device,
                                         mesh=mesh, **kwargs)
        # per-window record arrays (views of the raw data's record arena)
        # accumulate by reference and concatenate once per chunk, a view
        # where the chunk's windows lie in one arena base (the reference
        # stages through a 5M-row buffer, strax_interface.py:360); each
        # chunk's rows size the arena's next base (RecordArena.note_chunk)
        self.record_chunks: list = []
        self.record_buffer_rows = 5_000_000
        truth_per_n_pmts = (self._n_channels if self.config.get('per_pmt_truth')
                            else False)
        self.truth_dtype = extra_truth_dtype_per_pmt(truth_per_n_pmts)
        extra = list(self.config.get('_truth_extra_instruction_dtype', []))
        self.truth_buffer = np.zeros(
            10000, dtype=instruction_dtype + extra + self.truth_dtype
            + [('fill', bool)])
        self.blevel = 0

    @property
    def _n_channels(self):
        return len(self.config['gains'])

    def __call__(self, instructions, time_zero=None, **kwargs):
        if len(instructions) == 0:
            self.rawdata.source_finished = True
            return
        dt = self.config['sample_duration']
        buffer_length = self.record_buffer_rows
        rext = int(self.config['right_raw_extension'])
        cksz = int(self.config['chunk_size'] * 1e9)

        self.blevel = 0
        self.chunk_time_pre = (time_zero - rext if time_zero
                               else np.min(instructions['time']) - rext)
        self.chunk_time = self.chunk_time_pre + cksz
        self.current_digitized_right = self.last_digitized_right = 0

        for win in self.rawdata.iter_windows(
                instructions=instructions, truth_buffer=self._store_truth,
                **kwargs):
            records = win['records']
            records_needed = len(records)

            self.last_digitized_right = self.current_digitized_right
            self.current_digitized_right = win['win_right']

            if win['win_left'] * dt > self.chunk_time + rext \
                    and win.get('flush', True):
                # Pause the stream at a chunk boundary; extend the boundary if
                # it fell inside a digitized event
                # (reference: strax_interface.py:398-418). Sub-split windows
                # (flush=False) never pause: chunk boundaries see reference
                # flush-cache granularity.
                if (self.last_digitized_right + 1) * dt > self.chunk_time:
                    self.chunk_time = (self.last_digitized_right + 1) * dt
                yield from self.final_results()
                self.chunk_time_pre = self.chunk_time
                self.chunk_time += cksz

            if self.blevel + records_needed > buffer_length:
                log.warning('Chunk size too large, insufficient record buffer; '
                            'flushing early')
                self.chunk_time = (self.last_digitized_right + 1) * dt
                yield from self.final_results()
                self.chunk_time_pre = self.chunk_time
                self.chunk_time += cksz

            if self.blevel + records_needed > buffer_length:
                log.warning('Window too large, skipping records')
                continue

            if records_needed:
                self.record_chunks.append(records)
                self.blevel += records_needed

        self.last_digitized_right = self.current_digitized_right
        self.chunk_time = max((self.last_digitized_right + 1) * dt,
                              self.chunk_time_pre + dt)
        yield from self.final_results()

    def _store_truth(self, rows):
        """Write truth rows (dicts) into free slots of the truth buffer.
        The raw data hands over each super-batch's rows before its windows,
        and each chunk takes the rows it closes, so the buffer holds one
        super-batch and what is still pending; it grows where that does
        not fit."""
        free = np.flatnonzero(~self.truth_buffer['fill'])
        if len(free) < len(rows):
            keep = self.truth_buffer[self.truth_buffer['fill']]
            grown = np.zeros(max(2 * len(self.truth_buffer),
                                 len(keep) + len(rows) + 1000),
                             dtype=self.truth_buffer.dtype)
            grown[:len(keep)] = keep
            self.truth_buffer = grown
            free = np.arange(len(keep), len(grown))
        names = self.truth_buffer.dtype.names
        for ix, row in zip(free, rows):
            for k, v in row.items():
                if k in names:
                    self.truth_buffer[ix][k] = v
            self.truth_buffer[ix]['fill'] = True

    def final_results(self):
        t0 = _time.perf_counter()
        try:
            yield from self._final_results()
        finally:
            self.rawdata.diag.seconds['chunker_final'] += \
                _time.perf_counter() - t0

    def _final_results(self):
        t0 = _time.perf_counter()
        if self.record_chunks:
            records = concat_records(self.record_chunks)
        else:
            records = np.zeros(0, raw_record_dtype(DEFAULT_RECORD_LENGTH))
        # records arrive time-sorted (ascending windows x per-window
        # (time, channel)-sorted emission) — only sort when an edge case
        # actually broke the order; the chunk boundary is then a prefix
        # split, so the chunk's records are a VIEW and only the (usually
        # empty) leftover spills as a copy into the next chunk
        if len(records) > 1 and np.diff(records['time']).min() < 0:
            records = sort_by_time(records)
        n_keep = int(np.searchsorted(records['time'], self.chunk_time,
                                     side='right'))
        leftover = records[n_keep:].copy()
        records = records[:n_keep]
        RecordArena.note_chunk(len(records))
        self.record_chunks = [leftover] if len(leftover) else []
        self.blevel = len(leftover)
        self.rawdata.diag.seconds['final_records'] += \
            _time.perf_counter() - t0

        t0 = _time.perf_counter()
        maskb = (
            self.truth_buffer['fill']
            & ((self.truth_buffer['t_first_photon'] <= self.chunk_time)
               | (np.isnan(self.truth_buffer['t_first_photon'])
                  & (self.truth_buffer['time'] <= self.chunk_time))))
        truth = self.truth_buffer[maskb]          # a copy
        self.truth_buffer['fill'][maskb] = False

        truth.sort(order='time')
        _truth = np.zeros(len(truth), dtype=instruction_dtype + self.truth_dtype)
        for name in _truth.dtype.names:
            _truth[name] = truth[name]
        has_t = ~np.isnan(_truth['t_first_photon'])
        _truth['time'][has_t] = _truth['t_first_photon'][has_t].astype(int)
        _truth.sort(order='time')
        self.rawdata.diag.seconds['final_truth'] += _time.perf_counter() - t0

        if self.config['detector'] in ('XENON1T', 'XENONnT_neutron_veto'):
            yield dict(raw_records=records, truth=_truth)
        elif self.config['detector'] == 'XENONnT':
            he_lo = self.config['channel_map']['he'][0]
            he_hi = self.config['channel_map']['he'][-1]
            ch_max = int(records['channel'].max()) if len(records) else -1
            if ch_max < he_lo:
                # common (no-noise) regime: all records are TPC-only — skip
                # three full-array mask copies
                empty = records[:0]
                yield dict(raw_records=records, raw_records_he=empty,
                           raw_records_aqmon=empty, truth=_truth)
            else:
                yield dict(
                    raw_records=records[records['channel'] < he_lo],
                    raw_records_he=records[(records['channel'] >= he_lo)
                                           & (records['channel'] <= he_hi)],
                    raw_records_aqmon=records[records['channel'] == 800],
                    truth=_truth)

    def source_finished(self):
        return self.rawdata.source_finished
