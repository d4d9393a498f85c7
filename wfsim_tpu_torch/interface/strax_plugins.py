"""strax plugin layer (optional: requires strax + straxen; counterpart of
wfsim_tpu/interface/strax_plugins.py).

Defines the same plugin surface as the reference
(reference: wfsim/strax_interface.py:506-1017): ``RawRecordsFromFaxNT``,
``RawRecordsFromFax1T``, ``RawRecordsFromFaxOpticalNT``,
``RawRecordsFromMcChain``, ``RawRecordsFromFaxnVeto``,
``RawRecordsFromMcChain1T``, each building the port's ``ChunkRawRecords``
on ``SimulatorPlugin.device``: the card, ``'cuda'``.  The device is a plain
class attribute, not a strax option, so it changes no lineage; a subclass
or a test may set it to ``'cpu'`` to run the plain twins.

Import of this module is safe without strax: ``HAVE_STRAX`` is False and the
plugin classes are absent.
"""
from __future__ import annotations

import logging
from copy import deepcopy

import numpy as np

from ..config import finalize_config
from ..dtypes import (instruction_dtype, optical_extra_dtype,
                      extra_truth_dtype_per_pmt, DEFAULT_RECORD_LENGTH)
from ..pipeline.chunker import ChunkRawRecords
from ..pipeline.optical import RawDataOptical
from .instructions import rand_instructions, instruction_from_csv, read_optical
from .simulator import check_instructions

log = logging.getLogger('wfsim_tpu_torch.interface')

try:
    import strax
    import straxen
    from immutabledict import immutabledict
    HAVE_STRAX = True
except ImportError:
    HAVE_STRAX = False

__all__ = ['HAVE_STRAX']

if HAVE_STRAX:
    __all__ += ['SimulatorPlugin', 'RawRecordsFromFaxNT', 'RawRecordsFromFax1T',
                'RawRecordsFromFaxOpticalNT', 'RawRecordsFromMcChain',
                'RawRecordsFromFaxnVeto', 'RawRecordsFromMcChain1T']

    @strax.takes_config(
        strax.Option('detector', default='XENONnT', track=True, infer_type=False),
        strax.Option('event_rate', default=1000, track=False, infer_type=False),
        strax.Option('chunk_size', default=100, track=False, infer_type=False),
        strax.Option('n_chunk', default=10, track=False, infer_type=False),
        strax.Option('per_pmt_truth', default=False, track=True, type=bool),
        strax.Option('fax_file', default=None, track=False, infer_type=False),
        strax.Option('fax_config', default='fax_config_nt_design.json'),
        strax.Option('fax_config_override', default=None, infer_type=False),
        strax.Option('fax_config_override_from_cmt', default=None,
                     infer_type=False),
        strax.Option('channel_map', track=False, type=immutabledict),
        strax.Option('n_tpc_pmts', track=False, infer_type=False),
        strax.Option('n_top_pmts', track=False, infer_type=False),
        strax.Option('right_raw_extension', default=100000, infer_type=False),
        strax.Option('seed', default=False, track=False, infer_type=False),
    )
    class SimulatorPlugin(strax.Plugin):
        compressor = 'zstd'
        depends_on = tuple()
        rechunk_on_save = False
        parallel = False
        last_chunk_time = -999999999999999
        input_timeout = 3600
        #: the torch device of the simulation (not a strax option)
        device = 'cuda'

        gain_model_mc = straxen.URLConfig(
            default='cmt://to_pe_model?version=ONLINE&run_id=plugin.run_id',
            infer_type=False,
            help='PMT gain model. Specify as (model_type, model_config).')

        def setup(self):
            self.set_config()
            self.get_instructions()
            self.check_instructions()
            self._setup()

        def set_config(self):
            c = dict(self.config)
            c.update(straxen.get_resource(c['fax_config'], fmt='json'))
            overrides = c.get('fax_config_override')
            if overrides is not None:
                c.update(overrides)
            to_pe = self.gain_model_mc
            c['to_pe'] = to_pe
            c['channel_map'] = dict(c['channel_map'])
            if c.get('fax_config_override_from_cmt') is not None:
                for fax_field, cmt_option in \
                        c['fax_config_override_from_cmt'].items():
                    if (fax_field in ['fdc_3d', 's1_lce_correction_map']
                            and c.get('default_reconstruction_algorithm', False)):
                        cmt_option = tuple(
                            ['suffix', c['default_reconstruction_algorithm'],
                             *cmt_option])
                    c[fax_field] = straxen.get_correction_from_cmt(
                        self.run_id, cmt_option)
            self.config = finalize_config(c)
            if self.config['seed']:
                np.random.seed(self.config['seed'])

        def _setup(self):
            pass

        def get_instructions(self):
            pass

        def check_instructions(self):
            pass

        def _sort_check(self, results):
            if not isinstance(results, list):
                results = [results]
            last_chunk_time = self.last_chunk_time
            for result in results:
                if len(result) == 0:
                    continue
                if result['time'][0] < self.last_chunk_time + 1000:
                    raise RuntimeError(
                        'Simulator returned chunks with insufficient spacing')
                if len(result) > 1 and np.diff(result['time']).min() < 0:
                    raise RuntimeError('Simulator returned non-sorted records')
                last_chunk_time = max(result['time'].max(),
                                      self.last_chunk_time)
            self.last_chunk_time = last_chunk_time

        def is_ready(self, chunk_i):
            if 'ready' not in self.__dict__:
                self.ready = False
            self.ready ^= True
            return self.ready

        def source_finished(self):
            return self.sim.source_finished()

        @property
        def _n_channels(self):
            return len(self.config['gains'])

        @property
        def _truth_dtype(self):
            per = self._n_channels if self.config.get('per_pmt_truth') else False
            return extra_truth_dtype_per_pmt(per)

    class RawRecordsFromFaxNT(SimulatorPlugin):
        provides = ('raw_records', 'raw_records_he', 'raw_records_aqmon',
                    'truth')
        data_kind = immutabledict(zip(provides, provides))

        def _setup(self):
            self.sim = ChunkRawRecords(self.config, device=self.device)
            self.sim_iter = self.sim(self.instructions)

        def get_instructions(self):
            if self.config['fax_file']:
                if not self.config['fax_file'].endswith('csv'):
                    raise ValueError('Only csv input is supported')
                self.instructions = instruction_from_csv(self.config['fax_file'])
            else:
                self.instructions = rand_instructions(self.config)

        def check_instructions(self):
            self.instructions = check_instructions(self.instructions,
                                                   self.config)

        def infer_dtype(self):
            dtype = {dt: strax.raw_record_dtype(
                samples_per_record=DEFAULT_RECORD_LENGTH)
                for dt in self.provides if dt != 'truth'}
            dtype['truth'] = instruction_dtype + self._truth_dtype
            return dtype

        def compute(self):
            try:
                result = next(self.sim_iter)
            except StopIteration:
                raise RuntimeError('Bug in chunk count computation')
            self._sort_check(result[self.provides[0]])
            return {dt: self.chunk(start=self.sim.chunk_time_pre,
                                   end=self.sim.chunk_time,
                                   data=result[dt], data_type=dt)
                    for dt in self.provides}

    class RawRecordsFromFax1T(RawRecordsFromFaxNT):
        provides = ('raw_records', 'truth')

    class RawRecordsFromFaxOpticalNT(RawRecordsFromFaxNT):
        def _setup(self):
            self.sim = ChunkRawRecords(
                self.config, device=self.device,
                rawdata_generator=RawDataOptical,
                channels=self.channels, timings=self.timings)
            self.sim.truth_buffer = np.zeros(
                10000, dtype=instruction_dtype + optical_extra_dtype
                + self._truth_dtype + [('fill', bool)])
            self.sim_iter = self.sim(self.instructions)

        def get_instructions(self):
            if not self.config['fax_file'].endswith('.root'):
                raise ValueError('Optical simulation needs a root file')
            self.instructions, self.channels, self.timings = \
                read_optical(self.config)

    @strax.takes_config(
        strax.Option('epix_config', track=False, default={}, infer_type=False),
        strax.Option('entry_start', default=0, track=False, infer_type=False),
        strax.Option('entry_stop', default=None, track=False, infer_type=False),
        strax.Option('fax_config_nveto', default=None, track=True,
                     infer_type=False),
        strax.Option('fax_config_override_nveto', default=None, track=True,
                     infer_type=False),
        strax.Option('targets', default=('tpc',), track=False,
                     infer_type=False),
    )
    class RawRecordsFromMcChain(SimulatorPlugin):
        provides = ('raw_records', 'raw_records_he', 'raw_records_aqmon',
                    'raw_records_nv', 'truth', 'truth_nv')
        data_kind = immutabledict(zip(provides, provides))

        gain_model_nv = straxen.URLConfig(track=True, infer_type=False,
                                          help='nveto gain model')

        def set_config(self):
            super().set_config()
            if 'nveto' in self.config['targets']:
                self.config_nveto = deepcopy(dict(self.config))
                self.config_nveto.update(straxen.get_resource(
                    self.config_nveto['fax_config_nveto'], fmt='json'))
                self.config_nveto['detector'] = 'XENONnT_neutron_veto'
                self.config_nveto['channel_map'] = dict(
                    self.config_nveto['channel_map'])
                overrides = self.config.get('fax_config_override_nveto')
                if overrides is not None:
                    self.config_nveto.update(overrides)
                to_pe_nv = self.gain_model_nv
                self.config_nveto['gains'] = np.divide(
                    (2e-9 * 2 / 2 ** 14) / (1.6e-19 * 1 * 50), to_pe_nv,
                    out=np.zeros_like(to_pe_nv), where=to_pe_nv != 0)
                self.config_nveto['channels_bottom'] = np.array([], np.int64)
                self.config_nveto = finalize_config(self.config_nveto)

        def get_instructions(self):
            self.g4id = []
            if 'tpc' in self.config['targets']:
                import epix
                epix_config = deepcopy(self.config['epix_config'])
                epix_config.update({
                    'detector': self.config['detector'],
                    'entry_start': self.config['entry_start'],
                    'entry_stop': self.config['entry_stop'],
                    'input_file': self.config['fax_file']})
                self.instructions_epix = epix.run_epix.main(
                    epix.run_epix.setup(epix_config),
                    return_wfsim_instructions=True)
                self.g4id.append(self.instructions_epix['g4id'])
            if 'nveto' in self.config['targets']:
                self.instructions_nveto, self.nveto_channels, \
                    self.nveto_timings = read_optical(self.config_nveto)
                keep = (self.instructions_nveto['_last']
                        - self.instructions_nveto['_first']) >= 0
                self.instructions_nveto = self.instructions_nveto[keep]
                self.g4id.append(self.instructions_nveto['g4id'])
            self.g4id = np.unique(np.concatenate(self.g4id))
            self.set_timing()

        def set_timing(self):
            """Synchronized uniform event clock for TPC + nVeto
            (reference: strax_interface.py:824-863)."""
            if self.config['entry_stop'] is None:
                self.config['entry_start'] = int(np.min(self.g4id))
                self.config['entry_stop'] = int(np.max(self.g4id) + 1)
            rate = self.config['event_rate'] / 1e9
            timings = np.random.uniform(
                (self.config['entry_start'] + 0.5) / rate,
                (self.config['entry_stop'] + 0.5) / rate,
                self.config['entry_stop'] - self.config['entry_start'])
            timings = np.sort(timings).astype(np.int64)
            max_time = int((self.config['entry_stop'] + 0.5) / rate)
            grid = np.arange(self.config['entry_start'],
                             self.config['entry_stop'])
            if 'tpc' in self.config['targets']:
                i_t = np.searchsorted(grid, self.instructions_epix['g4id'])
                self.instructions_epix['time'] += timings[i_t]
                keep = self.instructions_epix['time'] <= max_time
                self.instructions_epix = self.instructions_epix[keep]
            if 'nveto' in self.config['targets']:
                i_t = np.searchsorted(grid, self.instructions_nveto['g4id'])
                self.instructions_nveto['time'] += timings[i_t]
                keep = self.instructions_nveto['time'] <= max_time
                self.instructions_nveto = self.instructions_nveto[keep]

        def check_instructions(self):
            if 'tpc' in self.config['targets']:
                self.instructions_epix = check_instructions(
                    self.instructions_epix, self.config)

        def _setup(self):
            if 'tpc' in self.config['targets']:
                self.sim = ChunkRawRecords(self.config, device=self.device)
                self.sim_iter = self.sim(
                    self.instructions_epix,
                    time_zero=int((self.config['entry_start'] + 0.5)
                                  / self.config['event_rate'] * 1e9))
            if 'nveto' in self.config['targets']:
                self.sim_nv = ChunkRawRecords(
                    self.config_nveto, device=self.device,
                    rawdata_generator=RawDataOptical,
                    channels=self.nveto_channels, timings=self.nveto_timings)
                self.sim_nv.truth_buffer = np.zeros(
                    10000, dtype=instruction_dtype + optical_extra_dtype
                    + self._truth_dtype + [('fill', bool)])
                self.sim_nv_iter = self.sim_nv(
                    self.instructions_nveto,
                    time_zero=int((self.config['entry_start'] + 0.5)
                                  / self.config['event_rate'] * 1e9))

        def infer_dtype(self):
            return {dt: (instruction_dtype + self._truth_dtype
                         if 'truth' in dt
                         else strax.raw_record_dtype(
                             samples_per_record=DEFAULT_RECORD_LENGTH))
                    for dt in self.provides}

        def compute(self):
            # Lock-step TPC + nVeto chunk emission
            # (reference: strax_interface.py:916-996)
            result = result_nv = None
            if 'tpc' in self.config['targets']:
                try:
                    result = next(self.sim_iter)
                except StopIteration:
                    if not self.sim.source_finished():
                        raise RuntimeError('Bug in getting source finished')
                    result = {dt: np.zeros(0, self.dtype_for(dt))
                              for dt in self.provides if 'nv' not in dt}
            if 'nveto' in self.config['targets']:
                try:
                    result_nv = next(self.sim_nv_iter)
                    result_nv['raw_records']['channel'] += \
                        self.config['channel_map']['nveto'][0]
                except StopIteration:
                    if not self.sim_nv.source_finished():
                        raise RuntimeError('Bug in getting source finished')
                    result_nv = {dt.replace('_nv', ''):
                                 np.zeros(0, self.dtype_for(dt))
                                 for dt in self.provides if 'nv' in dt}
            chunk = {}
            for dt in self.provides:
                if 'nv' in dt:
                    src, sim = result_nv, getattr(self, 'sim_nv', None)
                    key = dt.replace('_nv', '')
                else:
                    src, sim = result, getattr(self, 'sim', None)
                    key = dt
                if src is not None and key in src and sim is not None:
                    chunk[dt] = self.chunk(start=sim.chunk_time_pre,
                                           end=sim.chunk_time,
                                           data=src[key], data_type=dt)
                else:
                    other = self.sim if 'nv' in dt else getattr(self, 'sim_nv', None)
                    start = other.chunk_time_pre if other else 0
                    end = other.chunk_time if other else 0
                    chunk[dt] = self.chunk(
                        start=start, end=end,
                        data=np.zeros(0, self.dtype_for(dt)), data_type=dt)
            self._sort_check([chunk[dt].data for dt in self.provides])
            return chunk

        def source_finished(self):
            done = True
            if 'tpc' in self.config['targets']:
                done &= self.sim.source_finished()
            if 'nveto' in self.config['targets']:
                done &= self.sim_nv.source_finished()
            return done

    class RawRecordsFromFaxnVeto(RawRecordsFromMcChain):
        provides = ('raw_records_nv', 'truth_nv')
        data_kind = immutabledict(zip(provides, provides))

    class RawRecordsFromMcChain1T(RawRecordsFromMcChain):
        provides = ('raw_records', 'truth')
        data_kind = immutabledict(zip(provides, provides))
