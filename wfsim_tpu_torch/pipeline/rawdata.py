"""Host-side orchestration: instructions -> photons -> digitized records
(counterpart of wfsim_tpu/pipeline/rawdata.py; reference:
wfsim/core/rawdata.py:38-157).

The instructions, ordered by signal arrival time, are cut into
super-batches at large arrival gaps (:meth:`RawData._split_super_batches`,
wfsim_tpu's cuts: about ``ceil(n / pipeline_depth)`` instructions each, at
least ``pipeline_min_batch``), and the run streams one super-batch at a
time:

A) same-type batches (S1, S2, and the electron-afterpulse kinds pi_el and
   pe_el, which share the S2 chain) of the super-batch are simulated on
   the device with one ``torch.Generator`` per ``RawData`` (seeded from
   ``config['seed']``); their photons stay on the device as buffers and
   their truth rows come back to the host.  With PMT afterpulses on, every
   batch also gets its afterpulse photons as a buffer of their own (one
   pulse per truth row, no truth row of their own).  With electron
   afterpulses on, each S2 batch's photon summaries seed secondary pi_el /
   pe_el instructions on the host, which are simulated right after the
   super-batch's primaries (one level of feedback: secondaries spawn
   nothing); the super-batch's truth then goes to the truth buffer;
B) the pending pulses are grouped into digitization windows with the
   reference's flush-on-gap rule (rawdata.py:96-98).  A group that a pulse
   of a later super-batch could still join (its end within
   ``right_raw_extension`` of the next super-batch's ``safe_t``) waits,
   with every group after it, for the next round, so the framing is that
   of a single pass.  Each live group is sub-split at internal gaps that no
   ZLE interval can bridge (PARITY.md deviation 1) unless the high-energy
   copies are live (integer deamplification factor not 0, wfsim_tpu
   rawdata.py:1254-1259); with noise on, each window draws its noise-bank
   offset on the host;
C) the round's windows are bucketed by their power-of-two length
   ``T_cap`` and digitized in batches from a device photon arena of the
   buffers their pulses use (``gather_digitize`` -> ``pack_records``, on
   the slim or the full digitizer grid); the records come back to the host
   as strax ``raw_records`` and the windows are yielded.  A buffer that no
   pending pulse uses any more is dropped.

So device and host memory hold one super-batch and what is still pending,
not the run.  The host numpy generator (``self.rng``) is used in one
fixed order: per super-batch, secondary-instruction synthesis, then the
noise offsets of the round's windows in time order, so a rerun with the
same seed is identical.  The torch generator is drawn super-batch by
super-batch, so the draws depend on ``pipeline_depth`` (PARITY.md
deviation 5 is the same for wfsim_tpu).

In eager PyTorch every photon count is known before its buffer is
allocated, so wfsim_tpu's demand pre-pass (``s1_photon_demand`` /
``s2_photon_demand``) and its capacity retries fall away.  Left out as
wfsim_tpu relay and XLA machinery: the overlap of one super-batch's
device work with another's host work (its five-stage rotation and its
collector thread), sliced host copies, the packed device fetches, the
device-ceiling bench mode, the PRNG implementation switch and key-split
plumbing.

Absolute times are int64 on the host; the device sees int32 offsets from
per-batch and per-window bases.
"""
from __future__ import annotations

import logging
import typing as ty

import numpy as np
import torch

from ..config import finalize_config, PIPELINE_DEFAULTS
from ..diagnostics import Timers
from ..dtypes import raw_record_dtype, DEFAULT_RECORD_LENGTH
from ..models.afterpulse import (pmt_ap_draws, pmt_afterpulse_photons,
                                 summary_draws, photon_summaries,
                                 generate_pi_el_instructions,
                                 generate_pe_el_instructions)
from ..models.params import build_params, build_constants
from ..models.pmt import PER_PMT_SUMS
from ..models.s1 import simulate_s1, s1_models
from ..models.s2 import simulate_s2, check_supported
from ..resources.loader import load_config
from .digitize import gather_digitize, pack_records, noise_on, full_grid

log = logging.getLogger('wfsim_tpu_torch.core')

__all__ = ['RawData', 'resolve_device']

#: digitize working-set budget on a CPU device (bytes)
CPU_MEMORY_BUDGET = 2 * 10 ** 9

#: instruction type -> simulation kind; pi_el and pe_el run the S2 chain
KIND_OF_TYPE = {1: 's1', 2: 's2', 4: 'pi_el', 6: 'pe_el'}
TYPE_OF_KIND = {k: t for t, k in KIND_OF_TYPE.items()}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'wfsim_tpu_torch runs on a CUDA device by default and none is '
            'available; pass device="cpu" to run the plain PyTorch twins')
    return device


def _bucket(n, lo=256, hi=2 ** 26):
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


class _Pulse(ty.NamedTuple):
    """One truth row's photons: a contiguous slot range of one device
    photon buffer (``buf`` is the buffer's id)."""
    buf: int
    buf_start: int
    pool_count: int
    t_min: int                # abs ns (first photon)
    t_max: int                # abs ns (last photon)
    base_time: int            # abs ns base of the buffer's relative times


class RawData:
    """Behavioural counterpart of the reference ``RawData`` on one device.

    :param config: configuration dict (see :func:`config.default_config`)
    :param device: the torch device every tensor lives on: the card unless
        the caller asks for another; there is no fallback to the CPU
    """

    def __init__(self, config, *, device='cuda'):
        self.config = finalize_config(dict(config))
        self.device = resolve_device(device)
        self.resource = load_config(self.config)
        self.params = build_params(self.config, self.resource, self.device)
        self.const = build_constants(self.config)
        # model strings fail here, not mid-batch (wfsim_tpu
        # rawdata.py:299-321)
        s1_models(self.const.s1_model_type)
        check_supported(self.const)
        seed = self.config.get('seed') or 0
        self.rng = np.random.default_rng(seed if seed else None)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) if seed
                             else int(self.rng.integers(2 ** 31)))
        self.source_finished = False
        self.diag = Timers()
        self._reset_pending()

    def _reset_pending(self):
        """No photon buffer (by id) and no pulse pending."""
        self._buffers: ty.Dict[int, dict] = {}
        self._buf_ctr = 0
        self._pulses: ty.List[_Pulse] = []

    def _add_buffer(self, photons) -> int:
        bid = self._buf_ctr
        self._buf_ctr += 1
        self._buffers[bid] = photons
        return bid

    def _arrival_times(self, instructions):
        v = self.config['drift_velocity_liquid']
        return (instructions['time']
                + (instructions['z'] / v
                   * (instructions['type'] % 2 - 1)).astype(np.int64))

    # -- simulation ----------------------------------------------------------

    def _sim_batch_list(self, instructions, order):
        """Arrival-ordered same-chain batches bounded by instruction count,
        summed amplitude and int32 time span (wfsim_tpu _sim_batch_list)."""
        MAX_BATCH_INST = 1024
        MAX_BATCH_AMP = {'s1': 3_000_000, 's2': 200_000}
        MAX_SPAN_NS = int(15e8)
        batches: ty.Dict[str, list] = {k: [] for k in TYPE_OF_KIND}
        for i in order:
            k = KIND_OF_TYPE.get(int(instructions['type'][i]))
            if k is None:
                raise NotImplementedError(
                    f'instruction type {int(instructions["type"][i])}: the '
                    f'port simulates types {sorted(KIND_OF_TYPE)} only')
            batches[k].append(i)
        batch_list = []
        for kind, idxs in batches.items():
            if not idxs:
                continue
            idxs = np.asarray(idxs)
            t0 = instructions['time'][idxs].astype(np.int64)
            amps = instructions['amp'][idxs].astype(np.float64)
            cur, cur_amp, cur_t0 = [], 0.0, None
            for j, i in enumerate(idxs):
                if cur and (len(cur) >= MAX_BATCH_INST
                            or cur_amp + amps[j] > MAX_BATCH_AMP[
                                's1' if kind == 's1' else 's2']
                            or t0[j] - cur_t0 > MAX_SPAN_NS):
                    batch_list.append((kind, np.asarray(cur)))
                    cur, cur_amp, cur_t0 = [], 0.0, None
                if cur_t0 is None:
                    cur_t0 = t0[j]
                cur.append(i)
                cur_amp += amps[j]
            if cur:
                batch_list.append((kind, np.asarray(cur)))
        return batch_list

    def _truth_rows(self, instructions, idx, kind):
        """One truth row per instruction (save_full_truth), or S1s within
        100 ns / S2s within 2 mm of drift grouped (reference:
        rawdata.py:110-123); afterpulse kinds get one row per arrival
        cluster, split at gaps over ``right_raw_extension`` (reference
        rawdata.py:124-125, wfsim_tpu rawdata.py:427-437)."""
        if kind in ('s1', 's2') and self.config.get('save_full_truth', True):
            return np.arange(len(idx), dtype=np.int64)
        arrival = self._arrival_times(instructions[idx])
        if kind == 's1':
            gap = 100
        elif kind == 's2':
            gap = int(0.2 / self.config['drift_velocity_liquid'])
        else:
            gap = int(self.config['right_raw_extension'])
        new_grp = np.concatenate([[True], np.diff(arrival) > gap])
        return (np.cumsum(new_grp) - 1).astype(np.int64)

    def batch_inputs(self, instructions, idx, kind):
        """The device inputs of one batch: ``(inst, base_time, truth_rows,
        n_rows)`` with ``inst`` the dict of (I,) tensors the physics takes
        (times relative to ``base_time``) and ``truth_rows`` the host truth
        row of each instruction."""
        dev = self.device
        sel = instructions[idx]
        base_time = int(np.min(sel['time']))
        truth_rows = self._truth_rows(instructions, idx, kind)
        inst = dict(
            time=torch.as_tensor((sel['time'] - base_time).astype(np.int32),
                                 device=dev),
            x=torch.as_tensor(sel['x'].astype(np.float32), device=dev),
            y=torch.as_tensor(sel['y'].astype(np.float32), device=dev),
            z=torch.as_tensor(sel['z'].astype(np.float32), device=dev),
            amp=torch.as_tensor(sel['amp'].astype(np.int32), device=dev),
            recoil=torch.as_tensor(sel['recoil'].astype(np.int32), device=dev),
            local_field=torch.as_tensor(sel['local_field'].astype(np.float32),
                                        device=dev),
            e_dep=torch.as_tensor(sel['e_dep'].astype(np.float32), device=dev),
            truth_row=torch.as_tensor(truth_rows, device=dev))
        return inst, base_time, truth_rows, int(truth_rows.max()) + 1

    def _simulate_batch(self, instructions, idx, kind, truth_sink,
                        gen_sink=None):
        """Simulate one batch on the device, register its photons (and its
        PMT-afterpulse photons) as buffers and their pulses, append its
        truth rows and, for an S2 batch with ``gen_sink``, the secondary
        electron-afterpulse instructions it seeds."""
        dev = self.device
        sel = instructions[idx]
        inst, base_time, truth_rows, n_rows = self.batch_inputs(
            instructions, idx, kind)
        sim = simulate_s1 if kind == 's1' else simulate_s2
        with self.diag.phase('simulate_' + kind):
            photons, truth, req = sim(self.params, self.const, inst, self.gen,
                                      n_truth_rows=n_rows)
            truth_h = {k: v.cpu().numpy() for k, v in truth.items()}
            req = req.cpu().numpy()
        self.diag.add('photons_' + kind, int(truth_h['photon_count'].sum()))

        ap_h = None
        if self.const.enable_pmt_afterpulses \
                and self.params.pmt_ap_delay_cdf is not None:
            with self.diag.phase('pmt_afterpulses'):
                E = int(self.params.pmt_ap_delay_cdf.shape[0])
                draws = pmt_ap_draws(self.gen, E, int(photons['t'].shape[0]),
                                     dev)
                ap_photons, ap_info = pmt_afterpulse_photons(
                    self.params, self.const, photons, draws,
                    n_truth_rows=n_rows)
                ap_h = {k: ap_info[k].cpu().numpy()
                        for k in ('counts', 't_min', 't_max')}
            # these photons ride the digitizer but not the truth n_photon
            self.diag.add('pmt_ap_photons', ap_info['total'])

        # electron-afterpulse feedback: only true S2 pulses spawn it
        # (reference: rawdata.py:193-201; wfsim_tpu rawdata.py:645-658)
        if gen_sink is not None and kind == 's2' and (
                self.const.enable_electron_afterpulses
                or self.const.enable_gate_afterpulses):
            with self.diag.phase('electron_afterpulses'):
                counts, tz = photon_summaries(
                    photons, summary_draws(self.gen, n_rows, dev),
                    n_inst=n_rows)
                counts = counts.cpu().numpy()[:len(idx)]
                tz = tz.cpu().numpy()[:len(idx)]
                if self.const.enable_electron_afterpulses \
                        and self.resource.uniform_to_ele_ap is not None:
                    gen_sink.append(generate_pi_el_instructions(
                        self.config, self.resource, self.rng, counts, tz,
                        sel, base_time))
                if self.const.enable_gate_afterpulses:
                    gen_sink.append(generate_pe_el_instructions(
                        self.config, self.rng, counts, tz, sel, base_time))

        buf = self._add_buffer(photons)
        off = np.concatenate([[0], np.cumsum(req)]).astype(np.int64)
        if ap_h is not None:
            ap_buf = self._add_buffer(ap_photons)
            ap_off = np.concatenate([[0], np.cumsum(ap_h['counts'])]).astype(
                np.int64)
        for r in range(n_rows):
            members = np.flatnonzero(truth_rows == r)
            n_primary = int(truth_h['photon_count'][r])
            row = self._assemble_truth_row(kind, truth_h, r, base_time,
                                           sel[members])
            if row is not None:
                truth_sink.append(row)
            if n_primary > 0:
                slot_lo = int(off[members[0]])
                self._pulses.append(_Pulse(
                    buf=buf, buf_start=slot_lo,
                    pool_count=int(off[members[-1] + 1]) - slot_lo,
                    t_min=int(truth_h['photon_t_min'][r]) + base_time,
                    t_max=int(truth_h['photon_t_max'][r]) + base_time,
                    base_time=base_time))
            if ap_h is not None and int(ap_h['counts'][r]) > 0:
                self._pulses.append(_Pulse(
                    buf=ap_buf, buf_start=int(ap_off[r]),
                    pool_count=int(ap_h['counts'][r]),
                    t_min=int(ap_h['t_min'][r]) + base_time,
                    t_max=int(ap_h['t_max'][r]) + base_time,
                    base_time=base_time))

    def _assemble_truth_row(self, kind, truth_h, r, base_time, insts):
        """One truth dict (reference: rawdata.py:313-375; wfsim_tpu
        rawdata.py:766-836); None for an afterpulse row without photons
        (reference rawdata.py:334-337)."""
        if truth_h['photon_count'][r] == 0 and kind not in ('s1', 's2'):
            return None
        dt = self.const.sample_duration
        row = {'type': TYPE_OF_KIND[kind]}
        if truth_h['photon_count'][r] > 0:
            tmin = float(truth_h['photon_t_min'][r]) + base_time
            tmax = float(truth_h['photon_t_max'][r]) + base_time
            row.update(
                t_first_photon=tmin, t_last_photon=tmax,
                t_mean_photon=float(truth_h['photon_t_min'][r]
                                    + truth_h['photon_t_mean_offset'][r])
                + base_time,
                t_sigma_photon=float(truth_h['photon_t_sigma'][r]))
            row['endtime'] = int(tmax) + (
                self.const.samples_before_pulse_center
                + self.const.samples_after_pulse_center + 1) * dt
        else:
            row.update(t_first_photon=np.nan, t_last_photon=np.nan,
                       t_mean_photon=np.nan, t_sigma_photon=np.nan)
            row['endtime'] = int(insts['time'][0])
        if 'electron_count' in truth_h and truth_h['electron_count'][r] > 0:
            row.update(
                n_electron=int(truth_h['n_electron'][r]),
                t_first_electron=float(truth_h['electron_t_min'][r]) + base_time,
                t_last_electron=float(truth_h['electron_t_max'][r]) + base_time,
                t_mean_electron=float(truth_h['electron_t_min'][r]
                                      + truth_h['electron_t_mean_offset'][r])
                + base_time,
                t_sigma_electron=float(truth_h['electron_t_sigma'][r]))
        else:
            row.update(n_electron=0, t_first_electron=np.nan,
                       t_last_electron=np.nan, t_mean_electron=np.nan,
                       t_sigma_electron=np.nan)
        row['n_photon'] = int(truth_h['photon_count'][r])
        for f in ('n_pe', 'n_photon_trigger', 'n_pe_trigger',
                  'raw_area', 'raw_area_trigger'):
            row[f] = float(truth_h[f][r])
        if self.const.per_pmt_truth:
            # per-PMT vectors instead of the bottom-array fields (wfsim_tpu
            # rawdata.py:808-812)
            for f in PER_PMT_SUMS:
                row[f] = truth_h[f][r]
            row['n_photon'] = int(truth_h['n_photon'][r])
        else:
            for f in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger',
                      'raw_area', 'raw_area_trigger'):
                row[f + '_bottom'] = float(truth_h[f + '_bottom'][r])
        # instruction summary (reference: rawdata.py:363-372)
        for field in insts.dtype.names:
            v = insts[field]
            if len(insts) > 1 and field in 'xyz':
                row[field] = float(np.mean(v))
            elif len(insts) > 1 and field == 'amp':
                row[field] = int(np.sum(v))
            else:
                row[field] = v[0]
        if 'x_mean_electron' in truth_h:
            row['x_mean_electron'] = float(truth_h['x_mean_electron'][r])
            row['y_mean_electron'] = float(truth_h['y_mean_electron'][r])
        else:
            row['x_mean_electron'] = np.nan
            row['y_mean_electron'] = np.nan
        return row

    # -- main generator --------------------------------------------------------

    def iter_windows(self, instructions, truth_buffer=None, **kwargs):
        """Yield per digitization window a dict with win_left / win_right
        (absolute samples), ``flush`` and a time-sorted strax raw_record
        array, super-batch by super-batch (see the module docstring).  The
        truth rows (dicts) of a super-batch go to ``truth_buffer`` (a list
        they are appended to, or a callable taking them) before any window
        of its round is yielded."""
        if truth_buffer is None:
            truth_buffer = []
        self.source_finished = False
        self._reset_pending()
        instructions = np.asarray(instructions)
        arrival = self._arrival_times(instructions)
        order = np.argsort(arrival, kind='stable')
        for order_k, safe_t in self._split_super_batches(arrival, order):
            self._drain_truth(truth_buffer,
                              self.simulate(instructions, order_k))
            with self.diag.phase('digitize'):
                wins, records = self._dispatch_digitize(safe_t)
            for w, recs in zip(wins, records):
                yield dict(win_left=w['win_left'], win_right=w['win_right'],
                           flush=w['flush'], records=recs)
            del wins, records     # the caller holds what it keeps
        self.source_finished = True

    def _split_super_batches(self, arrival, order):
        """Cut the arrival-ordered instructions into super-batches; returns
        ``[(order_slice, safe_t), ...]`` (wfsim_tpu rawdata.py:1077-1105).

        ``safe_t`` is the earliest time a later super-batch can contribute a
        pulse: the next super-batch's first arrival minus a slack for
        photons that come before their arrival (S2 drift-diffusion spread,
        luminescence and gate-afterpulse jitter are well under it).  Cuts
        are placed only at arrival gaps above ``slack + 2 *
        right_raw_extension``, so that, with the flush-group deferral, the
        windows are framed as in a single pass."""
        n = len(order)
        depth = int(self.config.get('pipeline_depth',
                                    PIPELINE_DEFAULTS['pipeline_depth']))
        min_batch = int(self.config.get(
            'pipeline_min_batch', PIPELINE_DEFAULTS['pipeline_min_batch']))
        if n < 2 * min_batch or depth <= 1:
            return [(order, np.inf)]
        rext = int(self.config['right_raw_extension'])
        slack = 3 * rext + 100_000
        gap_thr = slack + 2 * rext
        target = max(int(np.ceil(n / depth)), min_batch)
        sa = np.asarray(arrival)[order]
        cuts = np.flatnonzero(np.diff(sa) > gap_thr) + 1
        batches = []
        start = 0
        for c in cuts:
            if c - start >= target and n - c >= target // 2:
                batches.append((order[start:c], float(sa[c]) - slack))
                start = c
        batches.append((order[start:], np.inf))
        return batches

    def simulate(self, instructions, order=None) -> ty.List[dict]:
        """Simulate one super-batch, the instructions ``order`` (by default
        all of them, in arrival order): its primaries, then the secondary
        electron-afterpulse instructions its S2s seeded (wfsim_tpu
        ``stage_a`` / ``stage_b``, rawdata.py:915-980).  The photons join
        the pending pulses on the device.  Returns the truth rows."""
        instructions = np.asarray(instructions)
        if order is None:
            order = np.argsort(self._arrival_times(instructions),
                               kind='stable')
        truth_rows: ty.List[dict] = []
        gen_sink: ty.List[np.ndarray] = []
        for kind, idx in self._sim_batch_list(instructions, order):
            self._simulate_batch(instructions, idx, kind, truth_rows,
                                 gen_sink)
        sec = [g for g in gen_sink if len(g)]
        if sec:
            sec = np.concatenate(sec)
            order = np.argsort(self._arrival_times(sec), kind='stable')
            for kind, idx in self._sim_batch_list(sec, order):
                self._simulate_batch(sec, idx, kind, truth_rows)
        self.diag.add('super_batches', 1)
        return truth_rows

    @staticmethod
    def _drain_truth(truth_buffer, truth_rows):
        if isinstance(truth_buffer, list):
            truth_buffer.extend(truth_rows)
        else:
            truth_buffer(truth_rows)

    # -- digitization ------------------------------------------------------------

    def _windows(self, safe_t=np.inf):
        """Window descriptors, in time order, of the pending pulses that no
        pulse at or after ``safe_t`` can join: flush-on-gap groups
        (reference: rawdata.py:96-98), those whose end reaches ``safe_t -
        right_raw_extension`` deferred with every group after them (group
        ends increase, so the deferred set is a suffix and the windows stay
        in time order; wfsim_tpu rawdata.py:1273-1287), each live group
        sub-split at unbridgeable internal gaps (PARITY.md deviation 1).
        The deferred pulses stay pending; the others leave."""
        if not self._pulses:
            return []
        c = self.const
        dt = c.sample_duration
        rext = int(self.config['right_raw_extension'])
        margin_l = (c.samples_to_store_before + c.samples_before_pulse_center
                    + c.trigger_window)
        margin_r = (c.samples_to_store_after + c.samples_after_pulse_center
                    + c.trigger_window)
        pulses = sorted(self._pulses, key=lambda p: p.t_min)
        holdoff_w = 2 * c.trigger_window + 1
        split_gap = self.config.get('split_digitize_gap_ns')
        if split_gap is None:
            split_gap = (max(4 * (margin_l + margin_r + holdoff_w) * dt,
                             20_000)
                         if c.high_energy_deamp_int == 0 else 0)

        groups: ty.List[ty.List[_Pulse]] = []
        cur = [pulses[0]]
        cur_end = pulses[0].t_max + margin_r * dt
        for p in pulses[1:]:
            if p.t_min - cur_end > rext:
                groups.append(cur)
                cur = [p]
            else:
                cur.append(p)
            cur_end = max(cur_end, p.t_max + margin_r * dt)
        groups.append(cur)

        deferred: ty.List[_Pulse] = []
        if safe_t != np.inf:
            live = []
            for grp in groups:
                g_end = max(p.t_max for p in grp) + margin_r * dt
                if deferred or g_end >= safe_t - rext:
                    deferred.extend(grp)
                else:
                    live.append(grp)
            groups = live
        self._pulses = deferred

        wins = []
        for grp in groups:
            sub = [grp[0]]
            first = True
            cur_end = grp[0].t_max + margin_r * dt
            for p in grp[1:]:
                if split_gap and p.t_min - margin_l * dt - cur_end > split_gap:
                    wins.append(self._window(sub, first, margin_l, margin_r))
                    first = False
                    sub = [p]
                else:
                    sub.append(p)
                cur_end = max(cur_end, p.t_max + margin_r * dt)
            wins.append(self._window(sub, first, margin_l, margin_r))
        return wins

    def _window(self, grp, flush, margin_l, margin_r):
        """One window descriptor; with noise on, its noise-bank offset is
        drawn here on the host, in window time order, with the window's
        exact length (wfsim_tpu rawdata.py:1337-1359; PARITY.md deviation
        3)."""
        dt = self.const.sample_duration
        win_left = min(p.t_min for p in grp) // dt - margin_l
        if win_left % 2 != 0:
            win_left -= 1      # digitizer quirk (reference rawdata.py:221)
        win_right = max(p.t_max for p in grp) // dt + margin_r
        T = int(win_right - win_left + 1)
        if T >= 1_000_000:
            raise RuntimeError('Pulse cache too long')
        nix = 0
        if noise_on(self.params, self.const):
            L = int(self.params.noise_bank.shape[1])
            nix = int(self.rng.integers(0, max(L - T - 1, 1)))
        return dict(grp=grp, win_left=int(win_left), win_right=int(win_right),
                    T_cap=_bucket(T, lo=512, hi=2 ** 20), flush=flush,
                    noise_ix=nix)

    def _memory_budget(self):
        """Bytes a digitize batch may use: half the free device memory on a
        card, a fixed budget on the CPU."""
        if self.device.type == 'cuda':
            free, _total = torch.cuda.mem_get_info(self.device)
            return free // 2
        return CPU_MEMORY_BUDGET

    def plan_digitize(self, safe_t=np.inf):
        """One digitize round: the windows of the pending pulses that no
        pulse at or after ``safe_t`` can join (:meth:`_windows`), the
        device photon arena of the buffers their pulses use, and the
        digitize batches: ``(wins, arena, batches)`` with arena = (t, ch,
        gain) tensors (None without windows) and each batch ``(window ids,
        T_cap, pieces, noise_ix)`` — windows bucketed by T_cap, at most 128
        per batch, pieces ``(B, P, 3)`` int64 ``[arena_lo, count,
        t_offset]``, noise_ix ``(B,)`` int32 (zeros with noise off).  The
        buffers no pending pulse uses any more are dropped."""
        c = self.const
        dt = c.sample_duration
        wins = self._windows(safe_t)
        still = {p.buf for p in self._pulses}
        used = sorted({p.buf for w in wins for p in w['grp']})
        arena = None
        if used:
            arena = tuple(torch.cat([self._buffers[b][k] for b in used])
                          for k in ('t', 'ch', 'gain'))
        base_of = dict(zip(used, np.concatenate([[0], np.cumsum(
            [int(self._buffers[b]['t'].shape[0]) for b in used])]).tolist()))
        for bid in list(self._buffers):
            if bid not in still:
                del self._buffers[bid]
        by_t: ty.Dict[int, list] = {}
        for i, w in enumerate(wins):
            by_t.setdefault(w['T_cap'], []).append(i)
        budget = self._memory_budget()
        # the grid and its ZLE working set dominate: ~8 bytes per
        # (row, sample) with the kernels, ~40 with the CPU twins (~64 with
        # the twin's noise gather); the full grid has n_channels_total rows
        if self.device.type == 'cuda':
            per_sample = 8
        else:
            per_sample = 64 if noise_on(self.params, c) else 40
        rows = (c.n_channels_total if full_grid(self.params, c)
                else c.n_tpc_pmts)
        batches = []
        for T_cap, indices in sorted(by_t.items()):
            b_max = max(1, budget // (rows * T_cap * per_sample))
            b_max = min(2 ** int(np.log2(b_max)), 128)
            for lo in range(0, len(indices), b_max):
                batch = np.asarray(indices[lo:lo + b_max])
                p_max = max(len(wins[i]['grp']) for i in batch)
                pieces = np.zeros((len(batch), p_max, 3), np.int64)
                for bi, wi in enumerate(batch):
                    win_base = wins[wi]['win_left'] * dt
                    for pi, p in enumerate(wins[wi]['grp']):
                        pieces[bi, pi] = (base_of[p.buf] + p.buf_start,
                                          p.pool_count,
                                          p.base_time - win_base)
                nix = np.asarray([wins[i]['noise_ix'] for i in batch],
                                 np.int32)
                batches.append((batch, T_cap, pieces, nix))
        return wins, arena, batches

    def _dispatch_digitize(self, safe_t=np.inf):
        """Digitize one round (:meth:`plan_digitize`); returns its windows
        and, per window, its time-sorted records."""
        with self.diag.phase('digitize_plan'):
            wins, arena, batches = self.plan_digitize(safe_t)
        if not wins:
            return [], []
        max_itv = int(self.config.get('zle_max_intervals', 64))
        parts = []
        with self.diag.phase('digitize_batches'):     # ends in host copies
            for batch, T_cap, pieces, nix in batches:
                res = gather_digitize(
                    self.params, self.const, *arena,
                    torch.as_tensor(pieces, device=self.device),
                    torch.as_tensor(nix, device=self.device),
                    n_samples=T_cap, max_intervals=max_itv)
                rec_data, rec_meta = pack_records(
                    res['data'], res['left_all'], res['starts'], res['ends'],
                    res['counts'])
                parts.append((batch, rec_data.cpu().numpy(),
                              rec_meta.cpu().numpy()))
        self.diag.add('rounds', 1)
        self.diag.add('digitize_calls', len(batches))
        self.diag.add('windows', len(wins))
        with self.diag.phase('digitize_host_records'):
            return wins, self._host_records(wins, parts)

    def _host_records(self, wins, parts):
        """strax raw_records per window of one round, time-sorted: (window,
        start, channel) order (wfsim_tpu _collect_digitize_work)."""
        dt = self.const.sample_duration
        spr = DEFAULT_RECORD_LENGTH
        W = np.concatenate([b[m[:, 0]] for b, _, m in parts])
        meta = np.concatenate([m for _, _, m in parts])
        data = np.concatenate([d for _, d, _ in parts])
        order = np.lexsort((meta[:, 1], meta[:, 2], W))
        W, meta, data = W[order], meta[order], data[order]
        win_left = np.asarray([w['win_left'] for w in wins], np.int64)
        recs = np.zeros(len(W), raw_record_dtype(spr))
        recs['time'] = (win_left[W] + meta[:, 2].astype(np.int64)) * dt
        recs['length'] = meta[:, 3]
        recs['dt'] = dt
        recs['channel'] = meta[:, 1]
        recs['pulse_length'] = meta[:, 4]
        recs['record_i'] = meta[:, 5]
        recs['data'] = data
        bounds = np.searchsorted(W, np.arange(len(wins) + 1))
        self.diag.add('records', len(recs))
        return [recs[bounds[i]:bounds[i + 1]] for i in range(len(wins))]
