#!/usr/bin/env python3
"""Smoke run of wfsim_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. device: needs ``torch.cuda.is_available()``; prints the nvidia-smi
   name/power-limit line, the torch and CUDA versions and ``nvcc --version``;
2. build: compiles ``wfsim_tpu_torch/csrc/*.cu`` into
   ``build/wfsim_tpu_torch/libkernels.so`` (nvcc, sm_90a) and prints the
   seconds and the ptxas resource lines;
3. kernels: each hand-written kernel against its plain PyTorch twin on the
   card, at main-path shapes (16 windows x 494 rows x 2048 samples, S2-like
   photons): bitwise equality required; median CUDA-event times of both;
4. main path: ``Simulator(default_config(seed=1234, chunk_size=100),
   device='cuda').get_arrays(inst)`` on the 512-event bench workload, once
   to warm up and once timed with the kernels' launch counts reset just
   before; checks the truth and the strax invariants of the records;
5. cross-check: one window batch of that workload digitized on the card and
   by the twins on the CPU, records bitwise equal.

Then the realistic configuration (noise overlay, PMT afterpulses, electron
afterpulses; the JAX package's ``bench.py`` "production realism" line):

3b. kernels at realistic shapes, bitwise against their twins on the card,
    with median CUDA-event times: PMT-afterpulse select+emit on ~1.5 M
    S2-like photons with the synthetic tables, the photon summaries, and
    ``superpose_adc`` with the noise bank and offsets that wrap its end;
4b. main path: ``Simulator(default_config(..., enable_noise=True,
    enable_pmt_afterpulses=True, enable_electron_afterpulses=True),
    device='cuda').get_arrays(inst)`` on the same workload, warm-up then
    timed, with the launch counts of every kernel on that path; checks the
    truth (type-4 rows included), the afterpulse photon fraction, the strax
    invariants and the noise on quiet in-window samples;
5b. cross-check: one realistic window batch, with its afterpulse pieces and
    noise offsets, on the card and by the CPU twins, records bitwise equal.

Then the physics passes (S1, S2 and the PMT response) of the default
configuration, on the bench workload's 512 S1 and 512 S2 instructions as
one batch each, with their draws made on the card:

3c. each physics kernel against its twin on the card, with median
    CUDA-event times of both: the channel draw (~1.57 M S2 photons over 512
    rows), the luminescence tables of 512 instructions (also held against
    the twin run on a CPU copy), the S1 photon, S2 electron and S2 photon
    time passes, the PMT photon pass and the row kernel (truth sums and
    time statistics); outputs bitwise equal, the float64 raw-area sums
    within rtol 1e-12;
5c. cross-check: the S1 and the S2 batch through the kernels on the card
    and, with the same draws copied to the CPU, through the CPU twins:
    photons bitwise equal, truth exact for the integer-valued fields and
    within rtol 1e-12 for the float sums.

Then the ``detector_physics`` configuration (NEST S1 timing, garfield
gas-gap luminescence, transverse diffusion 5e-8 cm^2/ns, AFT smearing,
inverse FDC with a constant dummy map, an S2 pattern map written from a
seed into a temporary directory in straxen's regular-grid JSON layout) on
the bench workload with ``local_field`` = 82 V/cm and ``e_dep`` = amp x
13.7 eV on every instruction:

3d. each new kernel against its twin on the card, with median CUDA-event
    times of both: the map lookup (1,024 points, on the 3-d FDC map with
    one output and on the 30 x 30 x 494 file pattern map), the diffused
    pattern of the 512-instruction S2 batch (~90 k electrons), the gas-gap
    luminescence times (~1.5 M photons) and the NEST delays (~7 k S1
    photons); max |diff| must be 0;
4d. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
    **detector_physics_overrides(map)), device='cuda').get_arrays(inst)``,
    warm-up then timed with the launch counts reset just before; every new
    entry point launched; one-off host costs (NEST table build, map read);
5d. cross-check: that workload's S1 and S2 batches through the kernels on
    the card and, from the same draws, through the twins on the CPU:
    photons bitwise equal, truth exact or within rtol 1e-12.

Then the ``he_full_grid`` configuration: the realistic switches, the three
resource files of a production configuration (an 801-channel noise bank,
the PMT-afterpulse CDFs and an SPE spectrum csv, written from a seed into
a temporary directory by ``write_production_files``) and a high-energy
deamplification factor of 1, so every digitize batch runs the full
XENONnT digitizer grid (494 TPC rows, 253 HE copies, the bottom-array sum
row; 801 rows a window):

3e. ``superpose_adc_full`` against its twin on the card, bitwise, at 16
    windows x 801 rows x 2048 samples with the 801-wide bank and offsets
    that wrap it, and the ZLE kernel in its full-grid mode on that grid;
    median CUDA-event times of both, the bound by bytes;
4e. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
    **he_full_grid_overrides(dir)), device='cuda').get_arrays(inst)``,
    warm-up then timed; launches of every kernel on the path (the
    full-grid entry once per digitize batch, the slim one never), records
    per split; ``raw_records_he`` non-empty and within 5 % of the
    top-array TPC record count, ``raw_records_aqmon`` empty;
5e. cross-check: one full-grid window batch on the card and by the CPU
    twins, records bitwise equal.

Then the ``timing_models`` configuration: the ``custom`` S1 timing model
(a delay by recoil class) and the ``garfield`` S2 luminescence model (a
wire-distance table, written from a seed into a temporary directory by
``write_garfield_table`` with three liquid levels, the nearest one read)
on the bench workload with the recoil ids cycling ER, NR, alpha, LED over
the events:

3f. ``custom_delays`` on the 512-instruction S1 batch and
    ``lumi_garfield_times`` on the 512-instruction S2 batch (~1.57 M
    photons), in its wire-rotation mode and in its confine mode, each
    against its twin on the card, bitwise; median CUDA-event times of
    both, the bound by bytes;
4f. main path: ``Simulator(default_config(seed=1234, chunk_size=100,
    **timing_models_overrides(file)), device='cuda').get_arrays(inst)``,
    warm-up then timed; every entry point of the path launched (the two
    new ones included, the simple luminescence tables never); truth rows
    by type, the S1 photon-time mean by recoil class with NR below ER, a
    positive photon time spread on every S2 truth row with photons;
5f. cross-check: the S1 and S2 batches through the kernels on the card
    and, from the same draws, through the twins on the CPU: photons
    bitwise equal, truth exact or within rtol 1e-12.

Then per-PMT truth and the XENON1T detector, each with the realistic
switches on the bench workload: ``per_pmt_truth`` (XENONnT, 494-wide
vectors per truth row) and ``xenon1t_full_grid`` (XENON1T: 248 TPC
channels, 127 of them top, deamplification factor 1, so every digitize
batch runs the full 801-row grid without HE rows, plus per-PMT truth):

3g. the per-PMT kernel (K16) against its twin on the 512-instruction S2
    batch of each configuration, after the PMT photon pass (~1.57 M
    photons, 494 and 248 channels): counts bitwise, raw areas within rtol
    1e-12; median CUDA-event times of both and of one ``index_add_`` of
    the photons' terms (the library call);
4g. main path: the per_pmt_truth run, warm-up then timed with every
    launch count set to 0 before it; every realistic entry and the
    per-PMT one launched; records bitwise those of the same run without
    per-PMT truth, whose bottom-array fields the vectors' bottom channels
    sum to (as the vectors sum to the row totals);
3h. ``superpose_adc_full`` without HE rows against its twin, bitwise, at
    16 windows x 801 rows x 2048 samples with the XENON1T bank and offsets
    that wrap it (rows 248-800 all 0); the bench positions checked against
    the configured TPC;
4h. main path: the xenon1t_full_grid run, warm-up then timed; the
    full-grid entry once per digitize batch, the slim one never, the
    per-PMT one launched; no ``raw_records_he`` key, every record on
    channels 0-247; records and truth bitwise those of the same run on
    the slim grid (factor 0) at the same framing (``split_digitize_gap_ns``
    0, which a non-zero factor implies), records bitwise those of the run
    without per-PMT truth, the vectors' sums as in 4g;
5h. one window batch without HE rows on the card and by the CPU twins,
    records bitwise equal.

Last, the stream (4s): the default configuration on 10,000 bench events
(20,000 instructions) with ``pipeline_depth`` = ceil(instructions / 1024),
super-batches of 1,000 instructions, and 1 s chunks; ``Simulator.run`` is
iterated and each chunk dropped.  Printed: super-batches and digitize
rounds, the time of the first chunk and the wall time, events/s, the peak
device memory (``torch.cuda.max_memory_allocated``, reset before the run;
also less what earlier phases still hold) and the host RSS high-water
(``VmRSS`` of /proc/self/status sampled per chunk, each sample after
``malloc_trim`` returns the heap's free pages).  The same run at 2,000
events, with the same super-batch size, goes first.  The phase fails
unless the long run's first chunk comes out before its last super-batch
is simulated, its device peak is at most 1.10 times the short run's, and
its RSS growth at most 1.25 times the short run's.

Every kernel row of the JSON table carries its bound: the least time the
card could take for the same work, the larger of the bytes its wrapper
must move (each input read once, each output written once, counted from
this run's tensors) over 3.35 TB/s and its arithmetic (counted from the
code on this run's sizes) over 67 TFLOP/s float32 plus 34 TFLOP/s
float64 (H100 SXM data sheet, non-tensor rates); and, where one PyTorch
call computes the same function, that call's time (``library_ms``: the
channel draw against ``torch.searchsorted`` over the CDF rows, the map
lookup against ``grid_sample``, the per-PMT truth against ``index_add_``).

The second-to-last line is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``.
"""
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: the physics kernel entries (K5, K6, K8, K9), on both main paths
PHYSICS_KERNELS = ('wfsim_channel_draw', 'wfsim_lumi_tables',
                   'wfsim_s1_photon_times', 'wfsim_s2_electron_times',
                   'wfsim_s2_photon_times', 'wfsim_pmt_photon_pass',
                   'wfsim_pmt_row_truth')
#: the kernel entries each main path must launch
DEFAULT_PATH_KERNELS = ('wfsim_superpose_adc', 'wfsim_zle_intervals',
                        'wfsim_pack_records', 'wfsim_grid_lookup'
                        ) + PHYSICS_KERNELS
REALISTIC_PATH_KERNELS = DEFAULT_PATH_KERNELS + (
    'wfsim_pmt_ap_select', 'wfsim_pmt_ap_emit', 'wfsim_ap_photon_summaries')
#: the detector_physics path: the gas-gap sampler replaces the simple
#: luminescence tables
DETECTOR_PATH_KERNELS = tuple(
    k for k in DEFAULT_PATH_KERNELS if k != 'wfsim_lumi_tables') + (
    'wfsim_pattern_diffuse', 'wfsim_lumi_gasgap_times', 'wfsim_nest_delays')

#: the he_full_grid path: the full-grid entry replaces superpose_adc
FULL_GRID_PATH_KERNELS = tuple(
    k for k in REALISTIC_PATH_KERNELS if k != 'wfsim_superpose_adc') + (
    'wfsim_superpose_adc_full',)

#: the timing_models path: the custom delays and the garfield times take
#: the place of the simple luminescence tables
TIMING_PATH_KERNELS = tuple(
    k for k in DEFAULT_PATH_KERNELS if k != 'wfsim_lumi_tables') + (
    'wfsim_s1_custom_delays', 'wfsim_lumi_garfield_times')

#: the per_pmt_truth path: the realistic one plus the per-PMT entry (K16)
PER_PMT_PATH_KERNELS = REALISTIC_PATH_KERNELS + (
    'wfsim_pmt_row_truth_per_pmt',)
#: the xenon1t_full_grid path: the full-grid entry (in its mode without HE
#: rows) in place of superpose_adc, and per-PMT truth
X1T_PATH_KERNELS = FULL_GRID_PATH_KERNELS + ('wfsim_pmt_row_truth_per_pmt',)

#: H100 SXM peaks (NVIDIA data sheet; at the 700 W limit): HBM3 bytes/s,
#: float32 and float64 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12


def nbytes(*xs):
    """Bytes of the tensors in ``xs`` (nested dicts, tuples and GridMaps
    walked; None and non-tensors count 0)."""
    import torch
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif hasattr(x, 'values') and hasattr(x, 'lows'):
            total += nbytes(x.values, x.lows, x.highs)
    return total


def bound(n_bytes, ops32=0, ops64=0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rates."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = ops32 / PEAK_F32 + ops64 / PEAK_F64
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def s2_like_arena(rng, n_win, n_ch, n_samples):
    """Per window ~4.6k photons (one bench S2), uniform over channels, times
    spread like a drifted S2 around the window centre, SPE-like gains."""
    t, ch, g, pieces = [], [], [], np.zeros((n_win, 1, 3), np.int64)
    lo = 0
    for w in range(n_win):
        n = int(rng.poisson(4600))
        tt = rng.normal(n_samples * 5, 1500, n) + rng.exponential(140, n)
        t.append(np.clip(tt, 600, n_samples * 10 - 600).astype(np.int32))
        ch.append(rng.integers(0, n_ch, n).astype(np.int32))
        gain = 2e6 * np.clip(rng.normal(1.0, 0.4, n), 0.05, None)
        gain *= np.where(rng.random(n) < 0.219, 2.0, 1.0)
        g.append(gain.astype(np.float32))
        pieces[w, 0] = (lo, n, 0)
        lo += n
    return np.concatenate(t), np.concatenate(ch), np.concatenate(g), pieces


def strax_valid(rr, n_ch):
    return bool(len(rr) and np.all(np.diff(rr['time']) >= 0)
                and rr['length'].max() <= 110 and rr['channel'].max() < n_ch
                and rr['channel'].min() >= 0 and rr['data'].min() >= 0
                and np.all(rr['pulse_length'] >= rr['length']))


def s2_like_photons(rng, n, n_ch, n_rows, dev):
    """A primary photon batch shaped like the bench S2 batch: ``n``
    photons over ``n_rows`` truth rows, uniform channels, 21.9 % double-PE,
    a few without a channel."""
    import torch
    ch = rng.integers(0, n_ch, n).astype(np.int32)
    ch[rng.random(n) < 0.01] = -1
    ph = dict(t=rng.integers(0, 3_000_000, n).astype(np.int32), ch=ch,
              is_dpe=rng.random(n) < 0.219, valid=ch >= 0,
              truth_row=np.sort(rng.integers(0, n_rows, n)).astype(np.int64))
    return {k: torch.as_tensor(v, device=dev) for k, v in ph.items()}


def max_diff(a, b):
    """max |a - b| over matching outputs (floats compared by their bits, so
    -0.0 and +0.0 differ; a difference is reported as at least the
    smallest positive value); raises on a shape mismatch."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f'{tuple(a.shape)} {a.dtype} vs '
                             f'{tuple(b.shape)} {b.dtype}')
    if not a.numel():
        return 0.0
    if a.dtype == torch.float32:
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            return max(float((a - b).abs().max()), 1e-45)
        return 0.0
    if a.dtype == torch.float64:
        if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
            return max(float((a - b).abs().max()), 1e-300)
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def physics_phases(sim):
    """The simulate_* Timers phases (seconds) of a Simulator's last run."""
    return {k: v for k, v in sim.sim.rawdata.diag.summary().items()
            if k.startswith('simulate_')}


def to_device(x, dev):
    """A (nested) dict of tensors, or a tensor, on ``dev`` (None kept)."""
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return None if x is None else x.to(dev)


def compare(a, b, what, rtol_keys=()):
    """Largest difference between two dicts (or tuples) of tensors: bitwise
    (``max_diff``) for every entry, relative for ``rtol_keys``, where it
    must stay within 1e-12.  Raises on a mismatch; returns the largest
    absolute difference."""
    import torch
    if not isinstance(a, dict):
        a, b = dict(enumerate(a)), dict(enumerate(b))
    if a.keys() != b.keys():
        raise AssertionError(f'{what}: keys {sorted(a)} vs {sorted(b)}')
    worst = 0.0
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if k in rtol_keys:
            if x.shape != y.shape or x.dtype != y.dtype:
                raise AssertionError(f'{what} {k}: {x.shape} {x.dtype} vs '
                                     f'{y.shape} {y.dtype}')
            d = (x - y).abs()
            rel = float((d / torch.clamp_min(y.abs(), 1e-300)).max()) \
                if x.numel() else 0.0
            if rel > 1e-12:
                raise AssertionError(f'{what} {k}: relative difference {rel}')
            worst = max(worst, float(d.max()) if x.numel() else 0.0)
            continue
        d = max_diff(x, y)
        if d:
            raise AssertionError(f'{what} {k}: max|diff| {d}')
    return worst


#: truth sums compared with rtol 1e-12 (float64 sums of float32 areas, and
#: the moments derived from the float64 time sums); the rest are exact
FLOAT_TRUTH = ('raw_area', 'raw_area_trigger', 'raw_area_bottom',
               'raw_area_trigger_bottom', 'photon_t_mean_offset',
               'photon_t_sigma', 'electron_t_mean_offset', 'electron_t_sigma',
               't_mean_offset', 't_sigma')


def physics_batches(cfg, inst, dev, seed):
    """Every S1 and every S2 instruction of ``inst`` as one batch each (512
    instructions, ~1.57 M S2 photons on the bench workload; the simulator
    cuts its S2 batches at 1.5 s of span, so this one is a little larger
    than its largest), with their draws made on the card from one
    generator: ``{kind: (inst dict, n_rows, draws)}``."""
    import torch
    from wfsim_tpu_torch.models.s1 import s1_draws
    from wfsim_tpu_torch.models.s2 import s2_draws
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    rd = RawData(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for kind, typ, draw in (('s1', 1, s1_draws), ('s2', 2, s2_draws)):
        x, _base, _rows, n_rows = rd.batch_inputs(
            inst, np.flatnonzero(inst['type'] == typ), kind)
        out[kind] = (x, n_rows, draw(rd.params, rd.const, x, gen))
    return rd.params, rd.const, out


def make_check(res, tag, smi):
    """A function that holds a kernel against its twin, times both and
    stores ``res[name] = dict(err, ms, plain_ms, bytes, ops32, ops64,
    library_ms)``; ``inputs`` are the tensors the kernel reads (its outputs
    are added to the byte count), ``library`` one PyTorch call computing
    the same function, timed beside it."""
    def check(name, kernel, twin, inputs, ops32, ops64=0, rtol_keys=(),
              reps=20, library=None):
        out = kernel()
        err = compare(out, twin(), name, rtol_keys)
        res[name] = dict(err=err, ms=cuda_ms(kernel, reps=reps),
                         plain_ms=cuda_ms(twin, reps=reps),
                         bytes=nbytes(inputs, out), ops32=ops32, ops64=ops64,
                         library_ms=(None if library is None
                                     else cuda_ms(library, reps=reps)))
        r = res[name]
        lib = ('' if library is None
               else f', library call {r["library_ms"]:.4f} ms')
        print(f'[{tag}] {name}: max|diff| {err}, {r["ms"]:.4f} ms, plain '
              f'twin {r["plain_ms"]:.4f} ms{lib}, bound '
              f'{bound(r["bytes"], ops32, ops64)[0]:.4f} ms ({smi})')
    return check


def searchsorted_library(pattern, ph_edges, u):
    """One ``torch.searchsorted`` over the CDF rows, the photons' targets
    padded per row: the library form of the channel draw."""
    import torch
    from wfsim_tpu_torch.ops.randsample import cumsum_f64
    cdf = cumsum_f64(pattern, 1)
    counts = (ph_edges[1:] - ph_edges[:-1]).cpu().numpy()
    width = max(int(counts.max()), 1)
    pos = torch.as_tensor(np.arange(int(counts.sum())) - np.repeat(
        ph_edges[:-1].cpu().numpy(), counts), device=u.device)
    rows = torch.as_tensor(np.repeat(np.arange(len(counts)), counts),
                           device=u.device)
    targets = torch.zeros((len(counts), width), device=u.device)
    targets[rows, pos] = u * cdf[rows, -1]
    return lambda: torch.searchsorted(cdf, targets, right=True)


def phase_3c(params, const, batches, dev, smi):
    """Each physics kernel against its twin on the card (see the module
    docstring); returns {name: measurements} (see make_check)."""
    import torch
    from wfsim_tpu_torch.models import pmt
    from wfsim_tpu_torch.models.s1 import (masked_pattern, row_edges_of,
                                           s1_photon_times,
                                           s1_photon_times_ref)
    from wfsim_tpu_torch.models.s2 import (
        get_s2_drift_time_params, luminescence_tables,
        luminescence_tables_ref, s2_edges, s2_electron_times,
        s2_electron_times_ref, s2_photon_times, s2_photon_times_ref, Q)
    from wfsim_tpu_torch.ops.randsample import channel_draw, channel_draw_ref
    from wfsim_tpu_torch.ops.segment import edges_from_counts
    x1, _n1, d1 = batches['s1']
    x2, n_rows, d2 = batches['s2']
    n_inst = int(x2['x'].shape[0])
    e_edges, e_ph_edges, ph_edges = s2_edges(d2)
    n_ph = int(ph_edges[-1])
    n_e = int(e_edges[-1])
    n_s1 = int(d1['n_hits'].sum())
    C = int(params.gains.shape[0])
    res = {}
    check = make_check(res, 'kernels-p', smi)

    pattern = masked_pattern(params, params.s2_pattern,
                             torch.stack([x2['x'], x2['y']], dim=1))
    print(f'[kernels-p] S2 batch: {n_inst} instructions, '
          f'{n_e} electrons, {n_ph} photons; S1 batch: '
          f'{int(x1["x"].shape[0])} instructions, {n_s1} photons')
    check('channel_draw', lambda: (channel_draw(pattern, ph_edges,
                                                d2['u_ch']),),
          lambda: (channel_draw_ref(pattern, ph_edges, d2['u_ch']),),
          (pattern, ph_edges, d2['u_ch']),
          ops32=n_ph * (int(np.log2(C)) + 2), ops64=n_inst * C,
          library=searchsorted_library(pattern, ph_edges, d2['u_ch']))

    inv = luminescence_tables(const, n_inst, dev)
    inv_cpu = luminescence_tables_ref(const, n_inst, 'cpu')
    compare((inv,), (inv_cpu,), 'lumi_tables against the CPU twin')
    R = int(round((const.gate_to_anode_distance - const.anode_wire_radius)
                  / 1e-4))
    check('lumi_tables', lambda: (luminescence_tables(const, n_inst, dev),),
          lambda: (luminescence_tables_ref(const, n_inst, dev),), (),
          ops32=n_inst * (R * 8 + Q * (int(np.log2(R)) + 6)),
          ops64=n_inst * R * 4)

    s1_args = (x1['time'], edges_from_counts(d1['n_hits']), x1['truth_row'],
               d1['exp'], d1['normal'])
    s1_kw = dict(decay_time=const.s1_decay_time,
                 decay_spread=const.s1_decay_spread)
    check('s1_photon_times', lambda: s1_photon_times(*s1_args, **s1_kw),
          lambda: s1_photon_times_ref(*s1_args, **s1_kw), s1_args,
          ops32=n_s1 * 4)

    mean, spread = get_s2_drift_time_params(const, x2['z'])
    e_args = (x2['time'], e_edges, mean, spread, d2['e_exp'], d2['e_normal'],
              x2['truth_row'])
    e_kw = dict(trapping=const.electron_trapping_time)
    check('s2_electron_times', lambda: s2_electron_times(*e_args, **e_kw),
          lambda: s2_electron_times_ref(*e_args, **e_kw), e_args,
          ops32=n_e * 5)
    e_t, _e_inst, e_row = s2_electron_times(*e_args, **e_kw)

    p_args = (inv, e_edges, e_ph_edges, e_t, x2['truth_row'], d2['u_lum'],
              d2['u_st'], d2['exp_st'], d2['t_spread'])
    p_kw = dict(singlet_fraction=const.singlet_fraction_gas,
                t_singlet=const.singlet_lifetime_gas,
                t_triplet=const.triplet_lifetime_gas,
                time_spread=const.s2_time_spread)
    check('s2_photon_times', lambda: s2_photon_times(*p_args, **p_kw),
          lambda: s2_photon_times_ref(*p_args, **p_kw), p_args,
          ops32=n_ph * (12 + int(np.log2(max(n_e // n_inst, 2)))))
    t, _ph_inst, truth_row = s2_photon_times(*p_args, **p_kw)

    ch = channel_draw(pattern, ph_edges, d2['u_ch'])
    pp_args = (params, const, t, ch, ch >= 0, truth_row, d2['pmt'])
    check('pmt_photon_pass', lambda: pmt._photon_pass(*pp_args),
          lambda: pmt.photon_pass_ref(*pp_args),
          (t, ch, truth_row, d2['pmt'], params.chan_pack,
           params.uniform_to_pe), ops32=n_ph * 16)
    ph = pmt._photon_pass(*pp_args)
    row_edges = row_edges_of(x2['truth_row'], ph_edges, n_rows)

    def row_ref():
        out = pmt.pulse_truth_ref(params, const, ph, row_edges)
        out.update(pmt.photon_time_stats_ref(ph['t'], ph['valid'], truth_row,
                                             n_rows, row_edges))
        return out
    check('pmt_row_truth',
          lambda: pmt._row_truth(params, const, ph['t'], ph['valid'],
                                 row_edges, ph=ph), row_ref,
          (ph, row_edges, params.chan_pack, params.current_max),
          ops32=n_ph * 8, ops64=n_ph * 14, rtol_keys=FLOAT_TRUTH)
    e_row_edges = row_edges_of(x2['truth_row'], e_edges, n_rows)
    err = compare(pmt._row_truth(None, None, e_t, None, e_row_edges),
                  pmt.photon_time_stats_ref(e_t, None, e_row, n_rows,
                                            e_row_edges),
                  'pmt_row_truth (electron times)', FLOAT_TRUTH)
    res['pmt_row_truth']['err'] = max(err, res['pmt_row_truth']['err'])
    print(f'[kernels-p] pmt_row_truth on the electron times: '
          f'max|diff| {err}')
    return res


def grid_sample_library(gmap, points):
    """One ``torch.nn.functional.grid_sample`` (align_corners=True, border
    padding) computing the same multilinear lookup as the kernel: the map
    as (1, C, [gz,] gy, gx), the points normalised to [-1, 1]."""
    import torch
    d = gmap.values.dim() - 1
    inp = gmap.values.permute(*range(d, -1, -1)).unsqueeze(0).contiguous()
    norm = (points - gmap.lows) / (gmap.highs - gmap.lows) * 2 - 1
    grid = norm.reshape((1,) * d + (points.shape[0], d)).contiguous()
    return lambda: torch.nn.functional.grid_sample(
        inp, grid, mode='bilinear', padding_mode='border',
        align_corners=True)


def phase_3d(params, const, batches, dev, smi):
    """Each detector_physics kernel against its twin on the card (see the
    module docstring); returns {name: measurements} (see make_check)."""
    import torch
    from wfsim_tpu_torch.models import s1, s2
    from wfsim_tpu_torch.ops.interp import grid_lookup, grid_lookup_ref
    from wfsim_tpu_torch.ops.segment import edges_from_counts
    x1, _n1, d1 = batches['s1']
    x2, _n_rows, d2 = batches['s2']
    n_inst = int(x2['x'].shape[0])
    e_edges, _e_ph_edges, ph_edges = s2.s2_edges(d2)
    n_e, n_ph = int(e_edges[-1]), int(ph_edges[-1])
    n_s1 = int(d1['n_hits'].sum())
    C = int(params.gains.shape[0])
    res = {}
    check = make_check(res, 'kernels-d', smi)
    print(f'[kernels-d] S2 batch: {n_inst} instructions, {n_e} electrons, '
          f'{n_ph} photons; S1 batch: {int(x1["x"].shape[0])} '
          f'instructions, {n_s1} photons')

    rng = np.random.default_rng(20261016)
    n_pts = 1024
    r = np.sqrt(rng.uniform(0, 45 ** 2, n_pts))
    phi = rng.uniform(-np.pi, np.pi, n_pts)
    pts3 = torch.as_tensor(np.stack([r * np.cos(phi), r * np.sin(phi),
                                     rng.uniform(-90, -10, n_pts)], 1),
                           dtype=torch.float32, device=dev)
    pts2 = pts3[:, :2].contiguous()
    for name, gmap, pts in (('grid_lookup_3d', params.fdc_3d, pts3),
                            ('grid_lookup', params.s2_pattern, pts2)):
        d = pts.shape[1]
        out_dim = int(gmap.values.shape[-1])
        args = (gmap.values, gmap.lows, gmap.highs, pts)
        check(name, lambda a=args: (grid_lookup(*a),),
              lambda a=args: (grid_lookup_ref(*a),), args,
              ops32=n_pts * (d * 6 + out_dim * 2 ** d * (d + 1)),
              library=grid_sample_library(gmap, pts))
        print(f'[kernels-d] {name}: map {tuple(gmap.values.shape)}, '
              f'{n_pts} points')

    z, xy = s2.s2_positions(params, const, x2)
    dif = s2.diffusion_inputs(const, z, xy)
    pd_args = (params.s2_pattern, xy[:, 0].contiguous(),
               xy[:, 1].contiguous(), *dif, const.tpc_radius ** 2, e_edges,
               d2['diff_r'], d2['diff_a'], C)
    check('pattern_diffuse', lambda: (s2.pattern_diffuse(*pd_args),),
          lambda: (s2.pattern_diffuse_ref(*pd_args),), pd_args,
          ops32=n_e * (40 + C * 8), ops64=n_e * C, reps=10)

    gg_args = (params.gg_inv_cdf, *s2.gasgap_rows(params, xy), ph_edges,
               d2['u_lum'])
    check('lumi_gasgap_times', lambda: (s2.lumi_gasgap_times(*gg_args),),
          lambda: (s2.lumi_gasgap_times_ref(*gg_args),), gg_args,
          ops32=n_ph * 16, ops64=n_ph * 2)

    nest_args = (*s1.nest_inputs(params, const, x1),
                 edges_from_counts(d1['n_hits']), d1['u_nest'])
    # the table rows this batch reads: its (class, field, energy) corners
    tbl, cls, fi0, fi1, _fw, ei0, ei1, _ew = nest_args[:8]
    corners = torch.cat([torch.stack([cls, fi, ei], 1)
                         for fi in (fi0, fi1) for ei in (ei0, ei1)])
    rows = tbl[tuple(torch.unique(corners, dim=0).T)]
    print(f'[kernels-d] nest_delays: {rows.shape[0]} table rows of '
          f'{rows.shape[1]} quantiles read')
    check('nest_delays', lambda: (s1.nest_delays(*nest_args),),
          lambda: (s1.nest_delays_ref(*nest_args),),
          nest_args[1:] + (rows,), ops32=n_s1 * 32)
    return res


def phase_5c(cfg, params_d, const, batches, smi, tag='cross-p'):
    """The S1 and S2 batches through the kernels on the card and, from the
    same draws, through the twins on the CPU (see the module docstring)."""
    import torch
    from wfsim_tpu_torch.models.params import build_params
    from wfsim_tpu_torch.models.s1 import s1_photon_pass
    from wfsim_tpu_torch.models.s2 import s2_photon_pass
    from wfsim_tpu_torch.resources import load_config
    params_c = build_params(cfg, load_config(cfg), 'cpu')
    cpu = torch.device('cpu')
    for kind, fn in (('s1', s1_photon_pass), ('s2', s2_photon_pass)):
        x, n_rows, draws = batches[kind]
        t0 = time.perf_counter()
        ph_d, tr_d, req_d = fn(params_d, const, x, draws, n_truth_rows=n_rows)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        ph_c, tr_c, req_c = fn(params_c, const, to_device(x, cpu),
                               to_device(draws, cpu), n_truth_rows=n_rows)
        t_cpu = time.perf_counter() - t0
        compare(ph_d, ph_c, f'{kind} photons card vs CPU')
        compare((req_d,), (req_c,), f'{kind} photon counts card vs CPU')
        err = compare(tr_d, tr_c, f'{kind} truth card vs CPU', FLOAT_TRUTH)
        print(f'[{tag}] {kind}: photons {int(ph_d["t"].shape[0])} rows '
              f'{n_rows}: photons bitwise equal, truth max|diff| {err} '
              f'(card {t_card:.3f} s, CPU twins {t_cpu:.3f} s; {smi})')


def phase_full_grid(sargs, skw, ph, B, T, K, inst, dev, smi):
    """Phases 3e, 4e and 5e (see the module docstring); returns the
    measurements of the superpose_adc_full row (see make_check) and the
    launch counts of the 4e run."""
    import torch
    from wfsim_tpu_torch.config import default_config, he_full_grid_overrides
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                              superpose_adc_full_ref)
    from wfsim_tpu_torch.ops.zle import zle_all_channels, zle_all_channels_ref
    from wfsim_tpu_torch.pipeline.digitize import (
        full_grid_rows, gather_digitize, pack_records)
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    from wfsim_tpu_torch.resources import load_config
    from wfsim_tpu_torch.resources.synthetic import write_production_files
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_he_')
    try:
        t0 = time.perf_counter()
        write_production_files(tmp, 1234)
        t_write = time.perf_counter() - t0
        cfg = default_config(seed=1234, chunk_size=100,
                             **he_full_grid_overrides(tmp))
        t0 = time.perf_counter()
        params = build_params(cfg, load_config(cfg), dev)
        t_load = time.perf_counter() - t0
        const = build_constants(cfg)
        C, R, n_top = (const.n_tpc_pmts, const.n_channels_total,
                       const.n_top_pmts)
        Cn, L = params.noise_bank.shape
        print(f'[full] one-off host costs: resource files written in '
              f'{t_write:.3f} s, read and moved to the card in {t_load:.3f} '
              f's; bank {Cn} x {L}, factor {const.high_energy_deamp_int}')

        # ---- 3e. the full-grid kernel against its twin -------------------
        nix = torch.as_tensor(L - T // 2 + np.arange(B) * 7,
                              dtype=torch.int32, device=dev)  # all wrap
        fkw = dict(skw, n_channels=C, n_channels_total=R, n_top=n_top,
                   he_start=const.he_channel_start,
                   sum_channel=const.sum_signal_channel,
                   deamp=const.high_energy_deamp_int,
                   noise_bank=params.noise_bank, noise_ix=nix)
        grid = superpose_adc_full(*sargs, **fkw)
        grid_ref = superpose_adc_full_ref(*sargs, **fkw)
        err = max_diff(grid, grid_ref)
        he = slice(const.he_channel_start, const.he_channel_start + n_top)
        print(f'[kernels-f] superpose_adc_full: {B} x {R} x {T}, noise_ix '
              f'{nix[0].item()}.. of L={L}, differing samples '
              f'{int((grid != grid_ref).sum())}, max|diff| {err}, HE rows '
              f'non-zero {int((grid[:, he] != 0).sum())}, sum row non-zero '
              f'{int((grid[:, const.sum_signal_channel] != 0).sum())}')
        if err or not grid[:, he].any():
            raise AssertionError('superpose_adc_full differs from its twin '
                                 'or leaves the HE rows empty')
        rows = [full_grid_rows(ph[k].reshape(B, C), const).reshape(-1)
                for k in ('ch_left', 'ch_right', 'has')]
        zthr = params.zle_thresholds[:R].repeat(B).contiguous()
        zkw = dict(holdoff=2 * const.trigger_window + 1,
                   trigger_window=const.trigger_window, max_intervals=K,
                   nonneg=True)
        zargs = (grid.reshape(B * R, T), zthr, *rows)
        zk = zle_all_channels(*zargs, **zkw)
        zr = zle_all_channels_ref(*zargs, **zkw)
        zerr = max(max_diff(a, b) for a, b in zip(zk, zr))
        print(f'[kernels-f] zle_intervals (full grid, nonneg): intervals '
              f'{int(zr[2].sum())} (HE rows '
              f'{int(zr[2].reshape(B, R)[:, he].sum())}), max|diff| {zerr}')
        if zerr:
            raise AssertionError('zle_intervals (nonneg) differs from its '
                                 'twin')
        ms = cuda_ms(lambda: superpose_adc_full(*sargs, **fkw))
        plain_ms = cuda_ms(lambda: superpose_adc_full_ref(*sargs, **fkw),
                           reps=5)
        # bytes: the inputs, the int16 grid, and one int16 bank read per
        # in-window sample of every banked row (the TPC rows and their HE
        # copies; the bank covers all 801); operations: a template tap per
        # photon and sample, the TPC epilogue, the HE epilogue or the sum
        span = torch.where(ph['has'], ph['ch_right'] - ph['ch_left'] + 1,
                           0).reshape(B, C)
        n_reads = int(span.sum()) + int(span[:, :n_top].sum())
        n_bytes = nbytes(sargs, nix, grid) + 2 * n_reads
        L_t = int(params.templates.shape[1])
        ops = (int(sargs[0].shape[0]) * L_t * 2 + B * C * T * 3
               + B * n_top * T * 4 + B * (C - n_top) * T * 2)
        b_ms, b_by = bound(n_bytes, ops)
        print(f'[kernels-f] superpose_adc_full: {ms:.4f} ms, plain twin '
              f'{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, library '
              f'call none ({smi})')
        m = dict(err=max(err, zerr), ms=ms, plain_ms=plain_ms,
                 bytes=n_bytes, ops32=ops, ops64=0, library_ms=None)
        del grid, grid_ref, zk, zr

        # ---- 4e. the he_full_grid main path ------------------------------
        out, wall, launches, peak, sim = timed_run(cfg, inst, dev)
        diag = sim.sim.rawdata.diag.summary()
        print(f'[full] launches {launches}')
        for name in FULL_GRID_PATH_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f'kernel {name} not launched on the '
                                     f'he_full_grid path')
        if (launches['wfsim_superpose_adc_full'] != diag['digitize_calls']
                or launches['wfsim_superpose_adc']):
            raise AssertionError('not every digitize batch ran the full grid')
        rr, rr_he, rr_aq = (out['raw_records'], out['raw_records_he'],
                            out['raw_records_aqmon'])
        truth = out['truth']
        n_top_rec = int((rr['channel'] < n_top).sum())
        n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
        print(f'[full] records per split: raw_records {len(rr)} (top array '
              f'{n_top_rec}), raw_records_he {len(rr_he)}, raw_records_aqmon '
              f'{len(rr_aq)}; truth rows by type {n_type}; windows '
              f'{diag["windows"]} in {diag["digitize_calls"]} batches')
        if not strax_valid(rr, C) or not len(rr_he) or len(rr_aq):
            raise AssertionError('he_full_grid records: invalid raw_records, '
                                 'empty raw_records_he or non-empty '
                                 'raw_records_aqmon')
        if not (rr_he['channel'].min() >= const.he_channel_start
                and rr_he['channel'].max() < he.stop
                and np.all(np.diff(rr_he['time']) >= 0)
                and rr_he['data'].min() >= 0):
            raise AssertionError('raw_records_he violate the strax '
                                 'invariants or leave channels 500-752')
        if abs(len(rr_he) - n_top_rec) > 0.05 * n_top_rec:
            raise AssertionError(f'HE records {len(rr_he)} not within 5 % of '
                                 f'the top-array records {n_top_rec}')
        if n_type[1] != 512 or n_type[2] != 512 or n_type[4] <= 0:
            raise AssertionError(f'truth rows by type {n_type}')
        n_photons = int(truth['n_photon'].sum())
        print(f'[full] events/s {512 / wall:.2f} wall {wall:.3f} s records '
              f'{len(rr) + len(rr_he) + len(rr_aq)} photons {n_photons} '
              f'peak_mem {peak / 2 ** 20:.1f} MiB ({smi})')
        print(f'[full] phases {diag}')

        # ---- 5e. one full-grid window batch: card against the CPU twins ---
        rd = RawData(cfg, device=dev)
        rd.simulate(inst)
        wins, arena_d, batches = rd.plan_digitize()
        # the longest windows up to T_cap 4096 (S2 windows), the batch with
        # the most of them, cut to 16 windows so the CPU twins stay quick
        cand = [b for b in batches if b[1] <= 4096] or batches
        batch, T_cap, pieces, nix_b = max(cand, key=lambda b: (b[1],
                                                               len(b[0])))
        batch, pieces, nix_b = batch[:16], pieces[:16], nix_b[:16]
        arena_c = [a.cpu() for a in arena_d]
        res = {}
        for name, d, ar in (('cuda', dev, arena_d),
                            ('cpu', torch.device('cpu'), arena_c)):
            prm = build_params(cfg, load_config(cfg), d)
            g = gather_digitize(prm, const, *ar,
                                torch.as_tensor(pieces, device=d),
                                torch.as_tensor(nix_b, device=d),
                                n_samples=T_cap, max_intervals=K)
            rec = pack_records(g['data'], g['left_all'], g['starts'],
                               g['ends'], g['counts'])
            res[name] = [x.cpu().numpy() for x in rec]
        same = all(a.shape == b.shape and np.array_equal(a, b)
                   for a, b in zip(res['cuda'], res['cpu']))
        meta = res['cuda'][1]
        n_he = int(((meta[:, 1] >= he.start) & (meta[:, 1] < he.stop)).sum())
        print(f'[cross-f] windows {len(batch)} T_cap {T_cap} rows {R} '
              f'records {len(meta)} (HE {n_he}) cuda==cpu {same}')
        if not same or not n_he:
            raise AssertionError('full-grid digitize on the card differs '
                                 'from the CPU twins (or has no HE record)')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return m, launches


def phase_timing_models(dev, smi):
    """Phases 3f, 4f and 5f (see the module docstring); returns the
    measurements of the custom_delays and lumi_garfield_times rows (see
    make_check) and the launch counts of the 4f run."""
    import torch
    from wfsim_tpu_torch.config import default_config, timing_models_overrides
    from wfsim_tpu_torch.interface import (timing_models_instructions,
                                           TIMING_MODEL_RECOILS)
    from wfsim_tpu_torch.models import s1, s2
    from wfsim_tpu_torch.ops.segment import edges_from_counts
    from wfsim_tpu_torch.resources.synthetic import write_garfield_table
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_tm_')
    try:
        path = write_garfield_table(Path(tmp) / 'garfield.npz', 1234)
        cfg = default_config(seed=1234, chunk_size=100,
                             **timing_models_overrides(path))
        inst = timing_models_instructions(512, 2000, 300)
        params, const, batches = physics_batches(cfg, inst, dev, 20261016)
        print(f'[timing] garfield table {tuple(params.garfield_t.shape)} '
              f'(liquid level of {path}), int mean {params.garfield_avgt}')

        # ---- 3f. the two kernels against their twins ----------------------
        res = {}
        check = make_check(res, 'kernels-t', smi)
        x1, _n1, d1 = batches['s1']
        x2, _n2, d2 = batches['s2']
        cls = s1.recoil_class(x1['recoil'])
        edges = edges_from_counts(d1['n_hits'])
        n_s1, n_i1 = int(edges[-1]), int(cls.shape[0])
        # the draws the kernel reads: its class's only (ER: the primary
        # uniform and a primary pair or the recombination uniform and a
        # secondary pair; NR, alpha: a pair; LED: one uniform)
        ph_cls = cls[torch.repeat_interleave(
            torch.arange(n_i1, device=dev), d1['n_hits'].long())]
        prim = d1['custom']['u_prim'] < float(
            np.float32(const.er_primary_excimer_fraction))
        reads = torch.where(ph_cls == 0, torch.where(prim, 3, 4),
                            torch.where(ph_cls == 3, 1, 2))
        c_args = (cls, edges, d1['custom'])
        check('custom_delays',
              lambda: (s1.custom_delays(*c_args, const=const),),
              lambda: (s1.custom_delays_ref(*c_args, const=const),),
              (cls, edges), ops32=n_s1 * (12 + int(np.log2(n_i1)) + 1))
        res['custom_delays']['bytes'] += 4 * int(reads.sum())
        per_cls = [int((ph_cls == c).sum()) for c in range(4)]
        print(f'[kernels-t] custom_delays: {n_s1} photons of {n_i1} '
              f'instructions, per class {per_cls}')

        _e, _eph, ph_edges = s2.s2_edges(d2)
        _z, xy = s2.s2_positions(params, const, x2)
        n_ph, n_i2 = int(ph_edges[-1]), int(xy.shape[0])
        R, M = params.garfield_t.shape
        g_kw = dict(avgt=params.garfield_avgt, tilt=const.anode_xaxis_angle,
                    pitch=const.anode_pitch)
        u_wire = torch.rand(n_i2, device=dev)
        for name, u, conf in (('lumi_garfield_times', None, -1.0),
                              ('lumi_garfield_times_confine', u_wire, 0.1)):
            g_args = (params.garfield_t, params.garfield_x, xy, ph_edges,
                      d2['col'], u)
            check(name,
                  lambda a=g_args, c=conf: (s2.lumi_garfield_times(
                      *a, **g_kw, confine=c),),
                  lambda a=g_args, c=conf: (s2.lumi_garfield_times_ref(
                      *a, **g_kw, confine=c),),
                  g_args, ops32=n_i2 * R * 3 + n_ph * (
                      3 + int(np.log2(n_i2)) + 1))
        print(f'[kernels-t] lumi_garfield_times: {n_ph} photons of {n_i2} '
              f'instructions, table {R} x {M}')

        # ---- 4f. the timing_models main path --------------------------------
        out, wall, launches, peak, sim = timed_run(cfg, inst, dev)
        diag = sim.sim.rawdata.diag.summary()
        print(f'[timing] launches {launches}')
        for name in TIMING_PATH_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f'kernel {name} not launched on the '
                                     f'timing_models path')
        if launches['wfsim_lumi_tables']:
            raise AssertionError('the simple luminescence tables ran')
        rr, truth = out['raw_records'], out['truth']
        n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2)}
        if n_type != {1: 512, 2: 512} or len(truth) != len(inst):
            raise AssertionError(f'timing_models truth rows {n_type}')
        s1_rows = truth[truth['type'] == 1]
        dt = s1_rows['t_mean_photon'] - s1_rows['time']
        by_cls = {int(r): float(np.mean(dt[s1_rows['recoil'] == r]))
                  for r in TIMING_MODEL_RECOILS}
        s2_rows = truth[truth['type'] == 2]
        lit = s2_rows['n_photon'] > 0
        print(f'[timing] truth rows by type {n_type}; S1 photon-time mean '
              f'after the instruction by recoil id {by_cls} ns; S2 rows with '
              f'photons {int(lit.sum())}, t_sigma_photon min '
              f'{float(s2_rows["t_sigma_photon"][lit].min()):.3f} ns')
        if not by_cls[0] < by_cls[7]:
            raise AssertionError('NR S1 photons not earlier than ER ones')
        if not np.all(s2_rows['t_sigma_photon'][lit] > 0):
            raise AssertionError('an S2 truth row with photons has no time '
                                 'spread')
        if not strax_valid(rr, const.n_tpc_pmts):
            raise AssertionError('timing_models raw_records violate the '
                                 'strax invariants')
        n_photons = int(truth['n_photon'].sum())
        print(f'[timing] events/s {512 / wall:.2f} wall {wall:.3f} s '
              f'records {len(rr)} photons {n_photons} peak_mem '
              f'{peak / 2 ** 20:.1f} MiB ({smi})')
        print(f'[timing] phases {diag}')

        # ---- 5f. the passes: card against the CPU twins ---------------------
        phase_5c(cfg, params, const, batches, smi, tag='cross-t')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, launches


def timed_run(cfg, inst, dev):
    """A warm-up ``get_arrays``, then a timed one with every launch count
    set to 0 just before; returns (out, wall_s, launches, peak device
    bytes, the timed Simulator)."""
    import torch
    from wfsim_tpu_torch import Simulator, _build
    Simulator(cfg, device=dev).get_arrays(inst)            # warm-up
    torch.cuda.synchronize()
    for k in _build.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    sim = Simulator(cfg, device=dev)
    t0 = time.perf_counter()
    out = sim.get_arrays(inst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    return out, wall, launches, torch.cuda.max_memory_allocated(dev), sim


def same_arrays(a, b):
    """Whether two ``get_arrays`` results hold the same keys and bytes."""
    return sorted(a) == sorted(b) and all(
        a[k].tobytes() == b[k].tobytes() for k in a)


def check_per_pmt(truth, off, n_top, tag):
    """The per-PMT vectors of ``truth`` sum over the channels to its
    totals and over the bottom array (channels >= n_top) to the bottom
    fields of ``off``, the same run without per-PMT truth: counts
    exactly, raw areas within rtol 1e-12.  Returns the largest relative
    difference of the areas."""
    if not (np.array_equal(truth['time'], off['time'])
            and np.array_equal(truth['type'], off['type'])):
        raise AssertionError(f'{tag}: truth rows differ from the run '
                             f'without per-PMT truth')
    worst = 0.0
    for name in ('n_photon', 'n_pe', 'n_photon_trigger', 'n_pe_trigger',
                 'raw_area', 'raw_area_trigger'):
        per = truth[name + '_per_pmt']
        for got, want in ((per.sum(1), truth[name]),
                          (per[:, n_top:].sum(1), off[name + '_bottom'])):
            if name.startswith('raw_area'):
                rel = float(np.max(np.abs(got - want)
                                   / np.maximum(np.abs(want), 1e-300)))
                worst = max(worst, rel)
                ok = rel <= 1e-12
            else:
                ok = np.array_equal(got, want)
            if not ok:
                raise AssertionError(f'{tag}: per-PMT {name} does not sum '
                                     f'to the row or bottom-array field')
    return worst


#: the per-PMT raw areas, compared within rtol 1e-12 (float64 atomics)
PER_PMT_AREAS = ('raw_area_per_pmt', 'raw_area_trigger_per_pmt')


def per_pmt_kernel_check(check, name, cfg, inst, dev):
    """K16 against its twin on the 512-instruction S2 batch of ``cfg``
    (the photons after the PMT photon pass); the library call is one
    ``index_add_`` of the photons' six terms into the (R * C, 6) table."""
    import torch
    from wfsim_tpu_torch.models import pmt, s2
    from wfsim_tpu_torch.models.s1 import row_edges_of
    params, const, batches = physics_batches(cfg, inst, dev, 20261016)
    x2, n_rows, d2 = batches['s2']
    ph, _truth, _req = s2.s2_photon_pass(params, const, x2, d2,
                                         n_truth_rows=n_rows)
    row_edges = row_edges_of(x2['truth_row'], s2.s2_edges(d2)[2], n_rows)
    C = int(params.gains.shape[0])
    n_ph, n_valid = int(ph['t'].shape[0]), int(ph['valid'].sum())
    idx, terms = pmt.per_pmt_inputs(params, const, ph, row_edges)
    check(name, lambda: pmt.pulse_truth_per_pmt(params, const, ph,
                                                row_edges),
          lambda: pmt.pulse_truth_per_pmt_ref(params, const, ph, row_edges),
          (*(ph[k] for k in ('t', 'ch', 'gain', 'is_dpe', 'valid')),
           row_edges, params.chan_pack, params.current_max),
          ops32=n_ph * 8 + n_valid * 4, ops64=n_valid * 2,
          rtol_keys=PER_PMT_AREAS,
          library=lambda: torch.zeros(
              (n_rows * C, 6), dtype=torch.float64,
              device=dev).index_add_(0, idx, terms))
    print(f'[kernels-x] {name}: {n_ph} photons ({n_valid} valid) in '
          f'{n_rows} rows x {C} channels')


def phase_per_pmt_x1t(B, T, K, inst, dev, smi):
    """Phases 3g, 4g, 3h, 4h and 5h (see the module docstring); returns
    the measurements of the per-PMT and the no-HE grid rows (see
    make_check) and the launch counts of the 4g and 4h runs."""
    import torch
    from wfsim_tpu_torch import Simulator
    from wfsim_tpu_torch.config import default_config
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.ops.waveform import (superpose_adc_full,
                                              superpose_adc_full_ref)
    from wfsim_tpu_torch.pipeline.digitize import (
        gather_digitize, pack_records, window_photons)
    from wfsim_tpu_torch.pipeline.rawdata import RawData
    from wfsim_tpu_torch.resources import load_config
    realism = dict(enable_noise=True, enable_pmt_afterpulses=True,
                   enable_electron_afterpulses=True)
    cfg_p = default_config(seed=1234, chunk_size=100, per_pmt_truth=True,
                           **realism)
    cfg_x = default_config(detector='XENON1T', seed=1234, chunk_size=100,
                           high_energy_deamplification_factor=1.0,
                           per_pmt_truth=True, **realism)
    n_ev = len(inst) // 2
    res = {}
    check = make_check(res, 'kernels-x', smi)

    # ---- 3g. K16 against its twin, XENONnT (494) and XENON1T (248) -------
    per_pmt_kernel_check(check, 'pulse_truth_per_pmt', cfg_p, inst, dev)
    per_pmt_kernel_check(check, 'pulse_truth_per_pmt_248', cfg_x, inst, dev)

    # ---- 4g. the per_pmt_truth main path -------------------------------
    out, wall, launches_p, peak, sim = timed_run(cfg_p, inst, dev)
    diag = sim.sim.rawdata.diag.summary()
    print(f'[per-pmt] launches {launches_p}')
    for name in PER_PMT_PATH_KERNELS:
        if launches_p[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the '
                                 f'per_pmt_truth path')
    off = Simulator(dict(cfg_p, per_pmt_truth=False),
                    device=dev).get_arrays(inst)
    truth = out['truth']
    n_top = cfg_p['n_top_pmts']
    n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
    if n_type[1] != n_ev or n_type[2] != n_ev or n_type[4] <= 0:
        raise AssertionError(f'per_pmt_truth truth rows by type {n_type}')
    if not strax_valid(out['raw_records'], cfg_p['n_tpc_pmts']):
        raise AssertionError('per_pmt_truth raw_records violate the strax '
                             'invariants')
    same = same_arrays({k: v for k, v in out.items() if k != 'truth'},
                       {k: v for k, v in off.items() if k != 'truth'})
    rel = check_per_pmt(truth, off['truth'], n_top, 'per_pmt_truth')
    print(f'[per-pmt] truth rows {len(truth)} by type {n_type}, vectors '
          f'{truth["n_photon_per_pmt"].shape}; records equal to the run '
          f'without per-PMT truth: {same}; per-PMT sums equal the totals '
          f'and the bottom fields (areas rel. diff. {rel:.3g})')
    if not same:
        raise AssertionError('per-PMT truth changed the records')
    print(f'[per-pmt] events/s {n_ev / wall:.2f} wall {wall:.3f} s records '
          f'{len(out["raw_records"])} truth rows {len(truth)} peak_mem '
          f'{peak / 2 ** 20:.1f} MiB ({smi})')
    print(f'[per-pmt] phases {diag}')
    del out, off, truth

    # ---- 3h. the grid without HE rows against its twin -----------------
    const = build_constants(cfg_x)
    params = build_params(cfg_x, load_config(cfg_x), dev)
    C, R = const.n_tpc_pmts, const.n_channels_total
    tpc_r, tpc_l = cfg_x['tpc_radius'], cfg_x['tpc_length']
    r_max = float(np.hypot(inst['x'], inst['y']).max())
    z_lo, z_hi = float(inst['z'].min()), float(inst['z'].max())
    print(f'[x1t] {C} TPC channels ({const.n_top_pmts} top) in {R} rows, '
          f'factor {const.high_energy_deamp_int}; bench positions r <= '
          f'{r_max:.2f} cm, z in [{z_lo:.2f}, {z_hi:.2f}] cm inside the TPC '
          f'(radius {tpc_r} cm, length {tpc_l} cm)')
    if not (r_max <= tpc_r and -tpc_l <= z_lo and z_hi <= 0):
        raise AssertionError('bench positions outside the XENON1T TPC')
    rng = np.random.default_rng(20261016)
    t_np, ch_np, g_np, pieces = s2_like_arena(rng, B, C, T)
    ph = window_photons(const, *(torch.as_tensor(a, device=dev)
                                 for a in (t_np, ch_np, g_np)),
                        torch.as_tensor(pieces, device=dev), n_samples=T)
    sargs = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
             ph['ch_left'], ph['ch_right'], ph['has'])
    L = int(params.noise_bank.shape[1])
    nix = torch.as_tensor(L - T // 2 + np.arange(B) * 7, dtype=torch.int32,
                          device=dev)                         # all wrap
    fkw = dict(current_2_adc=const.current_2_adc,
               baseline=const.digitizer_reference_baseline, n_samples=T,
               n_channels=C, n_channels_total=R, n_top=const.n_top_pmts,
               he_start=None, sum_channel=None,
               deamp=const.high_energy_deamp_int,
               noise_bank=params.noise_bank, noise_ix=nix)
    grid = superpose_adc_full(*sargs, **fkw)
    err = max_diff(grid, superpose_adc_full_ref(*sargs, **fkw))
    print(f'[kernels-x] superpose_adc_full (no HE rows): {B} x {R} x {T}, '
          f'{len(t_np)} photons, noise_ix {nix[0].item()}.. of L={L}, '
          f'max|diff| {err}, TPC rows non-zero '
          f'{int((grid[:, :C] != 0).sum())}, rows past the TPC non-zero '
          f'{int((grid[:, C:] != 0).sum())}')
    if err or grid[:, C:].any() or not grid[:, :C].any():
        raise AssertionError('superpose_adc_full without HE rows differs '
                             'from its twin or writes past the TPC')
    ms = cuda_ms(lambda: superpose_adc_full(*sargs, **fkw))
    plain_ms = cuda_ms(lambda: superpose_adc_full_ref(*sargs, **fkw), reps=5)
    # bytes: the inputs, the int16 grid and one int16 bank read per
    # in-window TPC sample; operations: a template tap per photon and
    # sample and the TPC epilogue (the zero rows are stores only)
    span = torch.where(ph['has'], ph['ch_right'] - ph['ch_left'] + 1, 0)
    n_bytes = nbytes(sargs, nix, grid) + 2 * int(span.sum())
    ops = (len(t_np) * int(params.templates.shape[1]) * 2 + B * C * T * 3)
    b_ms, b_by = bound(n_bytes, ops)
    print(f'[kernels-x] superpose_adc_full (no HE rows): {ms:.4f} ms, plain '
          f'twin {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, library '
          f'call none ({smi})')
    res['superpose_adc_full_no_he'] = dict(
        err=err, ms=ms, plain_ms=plain_ms, bytes=n_bytes, ops32=ops,
        ops64=0, library_ms=None)
    del grid, ph, sargs

    # ---- 4h. the xenon1t_full_grid main path ---------------------------
    out, wall, launches_x, peak, sim = timed_run(cfg_x, inst, dev)
    diag = sim.sim.rawdata.diag.summary()
    print(f'[x1t] launches {launches_x}')
    for name in X1T_PATH_KERNELS:
        if launches_x[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the '
                                 f'xenon1t_full_grid path')
    if (launches_x['wfsim_superpose_adc_full'] != diag['digitize_calls']
            or launches_x['wfsim_superpose_adc']):
        raise AssertionError('not every XENON1T digitize batch ran the '
                             'grid without HE rows')
    rr, truth = out['raw_records'], out['truth']
    n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
    if sorted(out) != ['raw_records', 'truth'] or not strax_valid(rr, C):
        raise AssertionError('xenon1t_full_grid: a raw_records_he key, or '
                             'records off the 248 TPC channels')
    if n_type[1] != n_ev or n_type[2] != n_ev or n_type[4] <= 0:
        raise AssertionError(f'xenon1t_full_grid truth rows by type {n_type}')
    slim = Simulator(dict(cfg_x, split_digitize_gap_ns=0,
                          high_energy_deamplification_factor=0.05),
                     device=dev).get_arrays(inst)
    same = same_arrays(out, slim)
    off = Simulator(dict(cfg_x, per_pmt_truth=False),
                    device=dev).get_arrays(inst)
    rel = check_per_pmt(truth, off['truth'], const.n_top_pmts,
                        'xenon1t_full_grid')
    print(f'[x1t] records {len(rr)} (channels {int(rr["channel"].min())}-'
          f'{int(rr["channel"].max())}), keys {sorted(out)}; truth rows '
          f'{len(truth)} by type {n_type}, vectors '
          f'{truth["n_photon_per_pmt"].shape}; windows {diag["windows"]} in '
          f'{diag["digitize_calls"]} batches; records and truth equal to the '
          f'slim grid at the same framing (factor 0, split gap 0): {same}; '
          f'per-PMT sums (areas rel. diff. {rel:.3g})')
    if not same or off['raw_records'].tobytes() != rr.tobytes():
        raise AssertionError('XENON1T records differ between the grid '
                             'without HE rows and the slim grid, or with '
                             'per-PMT truth off')
    print(f'[x1t] events/s {n_ev / wall:.2f} wall {wall:.3f} s records '
          f'{len(rr)} truth rows {len(truth)} peak_mem '
          f'{peak / 2 ** 20:.1f} MiB ({smi})')
    print(f'[x1t] phases {diag}')
    del out, slim, off

    # ---- 5h. one window batch without HE rows: card against CPU twins --
    rd = RawData(cfg_x, device=dev)
    rd.simulate(inst)
    _wins, arena_d, batches = rd.plan_digitize()
    cand = [b for b in batches if b[1] <= 4096] or batches
    batch, T_cap, pieces, nix_b = max(cand, key=lambda b: (b[1], len(b[0])))
    batch, pieces, nix_b = batch[:16], pieces[:16], nix_b[:16]
    recs = {}
    for d, ar in ((dev, arena_d), (torch.device('cpu'),
                                   [a.cpu() for a in arena_d])):
        prm = build_params(cfg_x, load_config(cfg_x), d)
        g = gather_digitize(prm, const, *ar, torch.as_tensor(pieces, device=d),
                            torch.as_tensor(nix_b, device=d),
                            n_samples=T_cap, max_intervals=K)
        if tuple(g['data'].shape) != (len(batch), R, T_cap):
            raise AssertionError(f'grid {tuple(g["data"].shape)}')
        recs[d.type] = [x.cpu().numpy() for x in pack_records(
            g['data'], g['left_all'], g['starts'], g['ends'], g['counts'])]
    same = all(a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(recs['cuda'], recs['cpu']))
    print(f'[cross-x] windows {len(batch)} T_cap {T_cap} rows {R} records '
          f'{len(recs["cuda"][1])} cuda==cpu {same}')
    if not same or not len(recs['cuda'][1]):
        raise AssertionError('XENON1T digitize on the card differs from the '
                             'CPU twins (or has no record)')
    return res, launches_p, launches_x


def trim_host_heap():
    """Hand the heap's free pages back to the system (glibc
    ``malloc_trim``), so an RSS sample counts what the process holds, not
    the free pages its heap happens to keep (they move the samples by
    ~50-150 MiB from chunk to chunk); False where the C library has no
    such call."""
    import ctypes
    import ctypes.util
    try:
        ctypes.CDLL(ctypes.util.find_library('c')).malloc_trim(0)
        return True
    except (OSError, AttributeError, TypeError):
        return False


def rss_mib():
    """This process's resident set (VmRSS of /proc/self/status) in MiB,
    read after :func:`trim_host_heap`."""
    trim_host_heap()
    for line in Path('/proc/self/status').read_text().splitlines():
        if line.startswith('VmRSS:'):
            return int(line.split()[1]) / 1024
    raise RuntimeError('/proc/self/status has no VmRSS')


def stream_run(n_events, dev, smi):
    """One run of phase 4s (see the module docstring) on ``n_events``
    bench events; returns its measurements."""
    import gc
    import torch
    from wfsim_tpu_torch import Simulator, default_config
    from wfsim_tpu_torch.interface import bench_instructions
    inst = bench_instructions(n_events, 2000, 300)
    depth = -(-len(inst) // 1024)
    cfg = default_config(seed=1234, chunk_size=1, pipeline_depth=depth)
    sim = Simulator(cfg, device=dev)
    rd = sim.sim.rawdata
    arrival = rd._arrival_times(inst)
    sizes = [len(o) for o, _ in rd._split_super_batches(
        arrival, np.argsort(arrival, kind='stable'))]
    gc.collect()
    trimmed = trim_host_heap()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2 ** 20   # earlier phases'
    rss0 = rss_mib()
    rss_hw = rss0
    n_chunks = n_rec = n_truth = 0
    first = first_sb = None
    t0 = time.perf_counter()
    for chunk in sim.run(inst):
        if first is None:
            first = time.perf_counter() - t0
            first_sb = rd.diag.counts['super_batches']
        n_chunks += 1
        n_rec += len(chunk['raw_records'])
        n_truth += len(chunk['truth'])
        del chunk
        rss_hw = max(rss_hw, rss_mib())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    m = dict(events=n_events, depth=depth, super_batches=len(sizes),
             batch_sizes=(min(sizes), max(sizes)),
             rounds=rd.diag.counts['rounds'], chunks=n_chunks,
             first_chunk_s=first, first_chunk_after_super_batches=first_sb,
             wall_s=wall, ev_s=n_events / wall, records=n_rec,
             peak_mib=peak, held_at_start_mib=held,
             run_peak_mib=peak - held, heap_trimmed=trimmed,
             rss_start_mib=rss0,
             rss_high_mib=rss_hw,
             rss_growth_mib=rss_hw - rss0)
    print(f'[stream] {n_events} events: {json.dumps(m)} ({smi})')
    if n_truth != len(inst):
        raise AssertionError(f'stream truth rows {n_truth} != {len(inst)}')
    if not first_sb < len(sizes):
        raise AssertionError('the first chunk came after the last '
                             'super-batch was simulated')
    return m


def phase_4s(dev, smi):
    """Phase 4s (see the module docstring); returns both runs'
    measurements."""
    short = stream_run(2_000, dev, smi)
    long = stream_run(10_000, dev, smi)
    # the peak counts the tensors earlier phases still hold; the run's own
    # peak is the part above them, and both ratios must hold
    peak_ratio = long['peak_mib'] / short['peak_mib']
    run_ratio = long['run_peak_mib'] / short['run_peak_mib']
    rss_ratio = long['rss_growth_mib'] / max(short['rss_growth_mib'], 1e-9)
    print(f'[stream] 10,000 / 2,000 events: device peak ratio '
          f'{peak_ratio:.4f}, above the tensors held before the runs '
          f'{run_ratio:.4f} (limit 1.10 for both), RSS growth ratio '
          f'{rss_ratio:.4f} (limit 1.25) ({smi})')
    if long['batch_sizes'] != short['batch_sizes']:
        print(f'[stream] super-batch sizes {long["batch_sizes"]} vs '
              f'{short["batch_sizes"]}')
    if max(peak_ratio, run_ratio) > 1.10 or rss_ratio > 1.25:
        raise AssertionError('memory grows with the run length')
    return short, long


def main():
    t_start = time.perf_counter()
    if not (ROOT / 'wfsim_tpu_torch' / '_build.py').exists():
        raise SystemExit('chip_smoke.py runs from the root of a wfsim_tpu '
                         'checkout (wfsim_tpu_torch/ not found)')
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: chip_smoke.py needs an NVIDIA GPU')

    # ---- 1. device -----------------------------------------------------
    smi = sh(['nvidia-smi', '--query-gpu=name,power.limit',
              '--format=csv,noheader']).splitlines()[0]
    dev = torch.device('cuda:0')
    kind = torch.cuda.get_device_name(0)
    print(f'[device] {smi}')
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    from wfsim_tpu_torch import _build
    nvcc_ver = sh([_build._nvcc(), '--version']).splitlines()[-1]
    print(f'[device] {nvcc_ver}')

    # ---- 2. build --------------------------------------------------------
    info = _build.build(ptxas_verbose=True)
    print(f'[build] {info["path"]} built={info["built"]} '
          f'seconds={info["seconds"]:.2f}')
    for line in info['log'].splitlines():
        if 'Used' in line or 'Compiling entry' in line:
            print(f'[build] {line.strip()}')

    from wfsim_tpu_torch import default_config
    from wfsim_tpu_torch.interface import bench_instructions
    from wfsim_tpu_torch.models.params import build_params, build_constants
    from wfsim_tpu_torch.resources import load_config
    from wfsim_tpu_torch.ops.waveform import superpose_adc, superpose_adc_ref
    from wfsim_tpu_torch.ops.zle import zle_all_channels, zle_all_channels_ref
    from wfsim_tpu_torch.pipeline.digitize import (
        window_photons, gather_digitize, pack_records, pack_records_ref)
    from wfsim_tpu_torch.pipeline.rawdata import RawData

    # ---- 3. kernels against their twins on the card -----------------------
    cfg = default_config(seed=1234, chunk_size=100)
    const = build_constants(cfg)
    params = build_params(cfg, load_config(cfg), dev)
    B, C, T, K = 16, const.n_tpc_pmts, 2048, 64
    rng = np.random.default_rng(20261016)
    t_np, ch_np, g_np, pieces = s2_like_arena(rng, B, C, T)
    arena = [torch.as_tensor(a, device=dev) for a in (t_np, ch_np, g_np)]
    ph = window_photons(const, *arena, torch.as_tensor(pieces, device=dev),
                        n_samples=T)
    print(f'[kernels] B={B} rows={B * C} T={T} photons={len(t_np)}')
    sargs = (ph['t'], ph['gain'], ph['row_ptr'], params.templates,
             ph['ch_left'], ph['ch_right'], ph['has'])
    skw = dict(current_2_adc=const.current_2_adc,
               baseline=const.digitizer_reference_baseline, n_samples=T)
    grid = superpose_adc(*sargs, **skw)
    grid_ref = superpose_adc_ref(*sargs, **skw)
    diff = (grid.to(torch.int32) - grid_ref.to(torch.int32)).abs()
    n_tie = int((diff > 0).sum())
    err1 = int(diff.max())
    print(f'[kernels] superpose_adc: tie samples {n_tie}, max|diff| {err1}, '
          f'samples below baseline in windows '
          f'{int(((grid_ref > 0) & (grid_ref < 16000)).sum())}')
    if n_tie:
        raise AssertionError('superpose_adc differs from its twin')

    zthr = params.zle_thresholds[:C].repeat(B).contiguous()
    zargs = (grid, zthr, ph['ch_left'], ph['ch_right'], ph['has'])
    zkw = dict(holdoff=2 * const.trigger_window + 1,
               trigger_window=const.trigger_window, max_intervals=K)
    zk = zle_all_channels(*zargs, **zkw)
    zr = zle_all_channels_ref(*zargs, **zkw)
    err2 = max(int((a - b).abs().max()) for a, b in zip(zk, zr))
    print(f'[kernels] zle_intervals: intervals {int(zr[2].sum())}, '
          f'max|diff| {err2}')
    if err2:
        raise AssertionError('zle_intervals differs from its twin')

    pargs = (grid.reshape(B, C, T), ph['ch_left'].reshape(B, C),
             zk[0].reshape(B, C, K), zk[1].reshape(B, C, K),
             zk[2].reshape(B, C))
    pk = pack_records(*pargs)
    pr = pack_records_ref(*pargs)
    if pk[0].shape != pr[0].shape or pk[1].shape != pr[1].shape:
        raise AssertionError(f'pack_records shapes {pk[0].shape} vs '
                             f'{pr[0].shape}')
    err3 = max(int((pk[0].to(torch.int32) - pr[0].to(torch.int32)).abs().max()),
               int((pk[1] - pr[1]).abs().max()))
    print(f'[kernels] pack_records: records {pk[0].shape[0]}, max|diff| {err3}')
    if err3:
        raise AssertionError('pack_records differs from its twin')

    times = dict(
        superpose_adc=(cuda_ms(lambda: superpose_adc(*sargs, **skw)),
                       cuda_ms(lambda: superpose_adc_ref(*sargs, **skw),
                               reps=5)),
        zle_intervals=(cuda_ms(lambda: zle_all_channels(*zargs, **zkw)),
                       cuda_ms(lambda: zle_all_channels_ref(*zargs, **zkw))),
        pack_records=(cuda_ms(lambda: pack_records(*pargs)),
                      cuda_ms(lambda: pack_records_ref(*pargs))))
    # bytes moved and operations of each call (see bound()): the grid's
    # samples get a template tap per photon and the ADC epilogue; ZLE a
    # compare and a few index updates per sample; the pack one copy
    L = int(params.templates.shape[1])
    work = dict(
        superpose_adc=(nbytes(sargs, grid), len(t_np) * L * 2 + B * C * T * 3),
        zle_intervals=(nbytes(zargs, zk), B * C * T * 4),
        pack_records=(nbytes(pargs, pk), int(pk[0].shape[0]) * 110))
    for name, (ms, plain) in times.items():
        b_ms, b_by = bound(*work[name])
        print(f'[kernels] {name}: {ms:.4f} ms, plain twin {plain:.4f} ms, '
              f'bound {b_ms:.4f} ms by {b_by} ({smi})')

    # ---- 4. main path ------------------------------------------------------
    inst = bench_instructions(512, 2000, 300)
    out, wall, launches, peak, sim = timed_run(cfg, inst, dev)
    rr, truth = out['raw_records'], out['truth']
    print(f'[main] launches {launches}')
    for name in DEFAULT_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the main path')
    if len(truth) != len(inst):
        raise AssertionError(f'truth rows {len(truth)} != {len(inst)}')
    if not strax_valid(rr, C):
        raise AssertionError('raw_records violate the strax invariants')
    s1 = truth[truth['type'] == 1]
    s2 = truth[truth['type'] == 2]
    ly = C * 14e-5 / (1 + cfg['p_double_pe_emision']) \
        * cfg['s1_detection_efficiency']
    expect = 2000 * ly
    if not np.all(np.abs(s1['n_photon'] - expect) < 6 * np.sqrt(expect) + 5):
        raise AssertionError('S1 photon counts off the binomial expectation')
    drift = -s2['z'] / cfg['drift_velocity_liquid'] + cfg['drift_time_gate']
    expect_e = 300 * np.exp(-drift / cfg['electron_lifetime_liquid'])
    if not np.all(np.abs(s2['n_electron'] - expect_e)
                  < 6 * np.sqrt(expect_e) + 5):
        raise AssertionError('S2 electron counts off the lifetime expectation')
    n_photons = int(truth['n_photon'].sum())
    print(f'[main] events/s {512 / wall:.2f} wall {wall:.3f} s records '
          f'{len(rr)} photons {n_photons} peak_mem '
          f'{peak / 2 ** 20:.1f} MiB ({smi})')
    print(f'[main] phases {sim.sim.rawdata.diag.summary()}')
    print(f'[main] physics phases {physics_phases(sim)}')

    # ---- 5. one window batch: card against the CPU twins -------------------
    rd = RawData(cfg, device=dev)
    rd.simulate(inst)
    wins, arena_d, batches = rd.plan_digitize()
    batch, T_cap, pieces, _nix = max(batches,
                                     key=lambda b: (b[1], len(b[0])))
    arena_c = [a.cpu() for a in arena_d]
    res = {}
    for name, d, ar in (('cuda', dev, arena_d), ('cpu', torch.device('cpu'),
                                                 arena_c)):
        prm = build_params(cfg, load_config(cfg), d)
        g = gather_digitize(prm, const, *ar, torch.as_tensor(pieces, device=d),
                            n_samples=T_cap, max_intervals=K)
        rec = pack_records(g['data'], g['left_all'], g['starts'], g['ends'],
                           g['counts'])
        res[name] = [x.cpu().numpy() for x in rec]
    same = all(np.array_equal(a, b) for a, b in zip(res['cuda'], res['cpu']))
    print(f'[cross] windows {len(batch)} T_cap {T_cap} records '
          f'{len(res["cuda"][0])} cuda==cpu {same}')
    if not same:
        raise AssertionError('digitize on the card differs from the CPU twins')

    # ---- 3b. realistic-config kernels against their twins -----------------
    from wfsim_tpu_torch.models.afterpulse import (
        pmt_ap_draws, pmt_afterpulse_photons, pmt_afterpulse_photons_ref,
        summary_draws, photon_summaries, photon_summaries_ref)
    cfg_r = default_config(seed=1234, chunk_size=100, enable_noise=True,
                           enable_pmt_afterpulses=True,
                           enable_electron_afterpulses=True)
    params_r = build_params(cfg_r, load_config(cfg_r), dev)
    const_r = build_constants(cfg_r)        # after build_params (AP metadata)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    n_ph, n_rows = 1_500_000, 512
    ph_ap = s2_like_photons(rng, n_ph, C, n_rows, dev)
    E = int(params_r.pmt_ap_delay_cdf.shape[0])
    draws = pmt_ap_draws(gen, E, n_ph, dev)
    ap_k, info_k = pmt_afterpulse_photons(params_r, const_r, ph_ap, draws,
                                          n_truth_rows=n_rows)
    ap_r, info_r = pmt_afterpulse_photons_ref(params_r, const_r, ph_ap, draws,
                                              n_truth_rows=n_rows)
    if info_k['total'] != info_r['total']:
        raise AssertionError(f'afterpulse totals {info_k["total"]} vs '
                             f'{info_r["total"]}')
    err4 = max([max_diff(ap_k[k], ap_r[k]) for k in ap_k]
               + [max_diff(info_k[k], info_r[k])
                  for k in ('counts', 't_min', 't_max')])
    print(f'[kernels-r] pmt_afterpulse: photons {n_ph} elements {E} '
          f'selected {info_k["total"]} ({info_k["total"] / n_ph:.4f} per '
          f'photon), max|diff| {err4}')
    if err4:
        raise AssertionError('pmt_afterpulse differs from its twin')
    u_s = summary_draws(gen, n_rows, dev)
    sk, sr = (f(ph_ap, u_s, n_inst=n_rows)
              for f in (photon_summaries, photon_summaries_ref))
    err5 = max(max_diff(a, b) for a, b in zip(sk, sr))
    print(f'[kernels-r] ap_photon_summaries: instructions {n_rows} '
          f'candidates {u_s.shape[1]}, max|diff| {err5}')
    if err5:
        raise AssertionError('ap_photon_summaries differs from its twin')
    L_noise = int(params_r.noise_bank.shape[1])
    nix = torch.as_tensor(L_noise - T // 2 + np.arange(B) * 7,
                          dtype=torch.int32, device=dev)  # all wrap the bank
    nkw = dict(skw, noise_bank=params_r.noise_bank, noise_ix=nix,
               n_channels=C)
    grid_n = superpose_adc(*sargs, **nkw)
    grid_nr = superpose_adc_ref(*sargs, **nkw)
    err6 = max_diff(grid_n, grid_nr)
    in_win = grid_nr[(grid_nr > 15900) & (grid_nr < 16100)].to(torch.float32)
    print(f'[kernels-r] superpose_adc+noise: noise_ix {nix[0].item()}.. of '
          f'L={L_noise}, differing samples {int((grid_n != grid_nr).sum())}, '
          f'max|diff| {err6}, quiet in-window std {in_win.std().item():.3f}')
    if err6 or not in_win.std().item() > 0.5:
        raise AssertionError('superpose_adc with noise differs from its twin '
                             'or shows no noise')
    times.update(
        pmt_afterpulse=(
            cuda_ms(lambda: pmt_afterpulse_photons(
                params_r, const_r, ph_ap, draws, n_truth_rows=n_rows)),
            cuda_ms(lambda: pmt_afterpulse_photons_ref(
                params_r, const_r, ph_ap, draws, n_truth_rows=n_rows))),
        ap_photon_summaries=(
            cuda_ms(lambda: photon_summaries(ph_ap, u_s, n_inst=n_rows)),
            cuda_ms(lambda: photon_summaries_ref(ph_ap, u_s, n_inst=n_rows))),
        superpose_adc_noise=(
            cuda_ms(lambda: superpose_adc(*sargs, **nkw)),
            cuda_ms(lambda: superpose_adc_ref(*sargs, **nkw), reps=5)))
    work.update(
        pmt_afterpulse=(nbytes(ph_ap, draws, params_r.pmt_ap_delay_cdf,
                               params_r.pmt_ap_amp_cdf, ap_k, info_k),
                        n_ph * E * 6),
        ap_photon_summaries=(nbytes(ph_ap, u_s, sk), n_ph * 4),
        superpose_adc_noise=(nbytes(sargs, grid_n) + B * C * T * 2,
                             len(t_np) * L * 2 + B * C * T * 4))
    for name in ('pmt_afterpulse', 'ap_photon_summaries',
                 'superpose_adc_noise'):
        ms, plain = times[name]
        b_ms, b_by = bound(*work[name])
        print(f'[kernels-r] {name}: {ms:.4f} ms, plain twin {plain:.4f} ms, '
              f'bound {b_ms:.4f} ms by {b_by} ({smi})')
    del ph_ap, draws, ap_k, ap_r, grid_n, grid_nr

    # ---- 4b. realistic main path -----------------------------------------
    out, wall_r, launches_r, peak_r, sim = timed_run(cfg_r, inst, dev)
    rr, truth = out['raw_records'], out['truth']
    diag = sim.sim.rawdata.diag.summary()
    print(f'[realistic] launches {launches_r}')
    for name in REALISTIC_PATH_KERNELS:
        if launches_r[name] <= 0:
            raise AssertionError(f'kernel {name} not launched on the '
                                 f'realistic path')
    n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2, 4, 6)}
    if n_type[1] != 512 or n_type[2] != 512 or n_type[4] <= 0:
        raise AssertionError(f'truth rows by type {n_type}')
    n_photons = int(truth['n_photon'].sum())
    ap_frac = diag['pmt_ap_photons'] / n_photons
    if not 0.012 < ap_frac < 0.05:
        raise AssertionError(f'afterpulse photon fraction {ap_frac}')
    if not strax_valid(rr, C):
        raise AssertionError('realistic raw_records violate the strax '
                             'invariants')
    j = np.arange(110)[None, :]
    inside = rr['data'][j < rr['length'][:, None]].astype(np.float64)
    quiet = inside[np.abs(inside - 16000) < 30]
    print(f'[realistic] truth rows by type {n_type}, afterpulse photons '
          f'{diag["pmt_ap_photons"]} of {n_photons} ({ap_frac:.4f}), quiet '
          f'samples mean {quiet.mean():.3f} std {quiet.std():.3f}')
    if not (15900 < quiet.mean() < 16100 and quiet.std() > 0.5):
        raise AssertionError('no noise on quiet in-window samples')
    print(f'[realistic] events/s {512 / wall_r:.2f} wall {wall_r:.3f} s '
          f'records {len(rr)} photons {n_photons} peak_mem '
          f'{peak_r / 2 ** 20:.1f} MiB ({smi})')
    print(f'[realistic] phases {diag}')
    print(f'[realistic] physics phases {physics_phases(sim)}')

    # ---- 5b. one realistic window batch: card against the CPU twins -------
    rd = RawData(cfg_r, device=dev)
    rd.simulate(inst)
    wins, arena_d, batches = rd.plan_digitize()
    # the batch with the most pieces beyond one per window (afterpulse
    # pulses join their S2's window as pieces of their own), cut to its 16
    # windows with the most pieces so the CPU twins stay quick
    batch, T_cap, pieces, nix = max(
        batches, key=lambda b: int((b[2][:, :, 1] > 0).sum()) - len(b[0]))
    top = np.argsort(-(pieces[:, :, 1] > 0).sum(axis=1), kind='stable')[:16]
    batch, pieces, nix = batch[top], pieces[top], nix[top]
    n_pieces = int((pieces[:, :, 1] > 0).sum())
    arena_c = [a.cpu() for a in arena_d]
    res = {}
    for name, d, ar in (('cuda', dev, arena_d), ('cpu', torch.device('cpu'),
                                                 arena_c)):
        prm = build_params(cfg_r, load_config(cfg_r), d)
        g = gather_digitize(prm, const_r, *ar,
                            torch.as_tensor(pieces, device=d),
                            torch.as_tensor(nix, device=d),
                            n_samples=T_cap, max_intervals=K)
        rec = pack_records(g['data'], g['left_all'], g['starts'], g['ends'],
                           g['counts'])
        res[name] = [x.cpu().numpy() for x in rec]
    same = all(a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(res['cuda'], res['cpu']))
    print(f'[cross-r] windows {len(batch)} pieces {n_pieces} T_cap {T_cap} '
          f'noise_ix {nix.tolist()[:4]}.. records {len(res["cuda"][0])} '
          f'cuda==cpu {same}')
    if not same or n_pieces <= len(batch):
        raise AssertionError('realistic digitize on the card differs from '
                             'the CPU twins (or the batch has no '
                             'afterpulse pieces)')

    # ---- 3c / 5c. the physics kernels and passes ---------------------------
    params_p, const_p, batches = physics_batches(cfg, inst, dev, 20261016)
    ptimes = phase_3c(params_p, const_p, batches, dev, smi)
    phase_5c(cfg, params_p, const_p, batches, smi)
    del params_p, batches

    # ---- 3d / 4d / 5d. the detector_physics configuration -----------------
    from wfsim_tpu_torch.config import detector_physics_overrides
    from wfsim_tpu_torch.interface import detector_physics_instructions
    from wfsim_tpu_torch.resources.nest_tables import build_nest_timing_tables
    from wfsim_tpu_torch.resources.synthetic import write_pattern_map
    tmp = tempfile.mkdtemp(prefix='wfsim_smoke_')
    try:
        t0 = time.perf_counter()
        map_path = write_pattern_map(Path(tmp) / 's2_pattern_map.json', 1234)
        t_write = time.perf_counter() - t0
        cfg_d = default_config(seed=1234, chunk_size=100,
                               **detector_physics_overrides(map_path))
        t0 = time.perf_counter()
        build_nest_timing_tables(cfg_d)
        t_nest = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_config(cfg_d)
        t_map = time.perf_counter() - t0
        print(f'[detector] one-off host costs: NEST table build {t_nest:.3f} '
              f's, map read {t_map:.3f} s (map file written in '
              f'{t_write:.3f} s)')
        inst_d = detector_physics_instructions(512, 2000, 300)
        params_d, const_d, batches_d = physics_batches(cfg_d, inst_d, dev,
                                                       20261016)
        dtimes = phase_3d(params_d, const_d, batches_d, dev, smi)

        out, wall_d, launches_d, peak_d, sim = timed_run(cfg_d, inst_d, dev)
        rr, truth = out['raw_records'], out['truth']
        diag = sim.sim.rawdata.diag.summary()
        print(f'[detector] launches {launches_d}')
        for name in DETECTOR_PATH_KERNELS:
            if launches_d[name] <= 0:
                raise AssertionError(f'kernel {name} not launched on the '
                                     f'detector_physics path')
        s2_rows = truth[truth['type'] == 2]
        n_type = {t: int((truth['type'] == t).sum()) for t in (1, 2)}
        r_shift = (np.hypot(s2_rows['x'], s2_rows['y'])
                   - np.hypot(s2_rows['x_mean_electron'],
                              s2_rows['y_mean_electron']))
        if n_type != {1: 512, 2: 512} or len(truth) != len(inst_d):
            raise AssertionError(f'detector_physics truth rows {n_type}')
        if not (np.all(np.isfinite(r_shift))
                and np.all(np.abs(r_shift - 0.5) < 0.05)):
            raise AssertionError('mean electron positions off the 0.5 cm '
                                 'inverse FDC')
        if not strax_valid(rr, C):
            raise AssertionError('detector_physics raw_records violate the '
                                 'strax invariants')
        n_photons = int(truth['n_photon'].sum())
        print(f'[detector] truth rows by type {n_type}, S2 photons '
              f'{int(s2_rows["n_photon"].sum())}, S1 photons '
              f'{n_photons - int(s2_rows["n_photon"].sum())}, electrons '
              f'{int(s2_rows["n_electron"].sum())}, mean r shift '
              f'{r_shift.mean():.4f} cm')
        print(f'[detector] events/s {512 / wall_d:.2f} wall {wall_d:.3f} s '
              f'records {len(rr)} photons {n_photons} peak_mem '
              f'{peak_d / 2 ** 20:.1f} MiB ({smi})')
        print(f'[detector] phases {diag}')
        print(f'[detector] physics phases {physics_phases(sim)}')
        phase_5c(cfg_d, params_d, const_d, batches_d, smi, tag='cross-d')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 3e / 4e / 5e. the he_full_grid configuration ----------------------
    ftimes, launches_f = phase_full_grid(sargs, skw, ph, B, T, K, inst, dev,
                                         smi)

    # ---- 3f / 4f / 5f. the timing_models configuration ---------------------
    ttimes, launches_t = phase_timing_models(dev, smi)

    # ---- 3g / 4g / 3h / 4h / 5h. per_pmt_truth and xenon1t_full_grid -------
    xtimes, launches_p, launches_x = phase_per_pmt_x1t(B, T, K, inst, dev,
                                                       smi)

    # ---- 4s. the stream ----------------------------------------------------
    phase_4s(dev, smi)

    src = 'wfsim_tpu_torch/csrc/'
    rows = []

    def row(name, cu, replaces, entries, launches, err, ms, plain_ms,
            n_bytes, ops32, ops64=0, library_ms=None):
        b_ms, b_by = bound(n_bytes, ops32, ops64)
        rows.append(dict(name=name, route='cuda', source=src + cu,
                         replaces=replaces, entry_points=list(entries),
                         launches=launches, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms))

    def measured(name, cu, replaces, entries, launch_counts, m):
        row(name, cu, replaces, entries,
            min(launch_counts[e] for e in entries), m['err'], m['ms'],
            m['plain_ms'], m['bytes'], m['ops32'], m['ops64'],
            m['library_ms'])

    row('superpose_adc', 'superpose_adc.cu',
        'wfsim_tpu/ops/waveform.py:68; wfsim_tpu/pipeline/digitize.py:67',
        ['wfsim_superpose_adc'], launches['wfsim_superpose_adc'],
        max(err1, err6), *times['superpose_adc'], *work['superpose_adc'])
    measured('superpose_adc_full', 'superpose_adc.cu',
             'wfsim_tpu/pipeline/digitize.py:341; '
             'wfsim_tpu/pipeline/digitize.py:96',
             ['wfsim_superpose_adc_full'], launches_f, ftimes)
    row('zle_intervals', 'zle_intervals.cu', 'wfsim_tpu/ops/zle.py:119',
        ['wfsim_zle_intervals'], launches['wfsim_zle_intervals'], err2,
        *times['zle_intervals'], *work['zle_intervals'])
    row('pack_records', 'pack_records.cu',
        'wfsim_tpu/pipeline/digitize.py:471', ['wfsim_pack_records'],
        launches['wfsim_pack_records'], err3, *times['pack_records'],
        *work['pack_records'])
    row('pmt_afterpulse', 'pmt_afterpulse.cu',
        'wfsim_tpu/models/afterpulse.py:56',
        ['wfsim_pmt_ap_select', 'wfsim_pmt_ap_emit'],
        min(launches_r['wfsim_pmt_ap_select'],
            launches_r['wfsim_pmt_ap_emit']), err4,
        *times['pmt_afterpulse'], *work['pmt_afterpulse'])
    row('ap_photon_summaries', 'pmt_afterpulse.cu',
        'wfsim_tpu/models/afterpulse.py:184', ['wfsim_ap_photon_summaries'],
        launches_r['wfsim_ap_photon_summaries'], err5,
        *times['ap_photon_summaries'], *work['ap_photon_summaries'])
    for name, cu, rep in (
            ('channel_draw', 'channel_draw.cu',
             'wfsim_tpu/ops/randsample.py:120; '
             'wfsim_tpu/ops/randsample.py:99'),
            ('lumi_tables', 'luminescence.cu',
             'wfsim_tpu/models/s2.py:167; wfsim_tpu/models/s2.py:141'),
            ('s1_photon_times', 'photon_times.cu',
             'wfsim_tpu/models/s1.py:143'),
            ('s2_electron_times', 'photon_times.cu',
             'wfsim_tpu/models/s2.py:381'),
            ('s2_photon_times', 'photon_times.cu',
             'wfsim_tpu/models/s2.py:441'),
            ('pmt_photon_pass', 'pmt_response.cu',
             'wfsim_tpu/models/pmt.py:19'),
            ('pmt_row_truth', 'pmt_response.cu',
             'wfsim_tpu/models/pmt.py:89; wfsim_tpu/models/pmt.py:171')):
        measured(name, cu, rep, ['wfsim_' + name], launches, ptimes[name])
    for name, entry, cu, rep in (
            ('grid_lookup', 'wfsim_grid_lookup', 'grid_lookup.cu',
             'wfsim_tpu/ops/interp.py:85'),
            ('grid_lookup_3d', 'wfsim_grid_lookup', 'grid_lookup.cu',
             'wfsim_tpu/ops/interp.py:85'),
            ('pattern_diffuse', 'wfsim_pattern_diffuse', 'grid_lookup.cu',
             'wfsim_tpu/models/s2.py:300'),
            ('lumi_gasgap_times', 'wfsim_lumi_gasgap_times',
             'table_samplers.cu', 'wfsim_tpu/models/s2.py:255'),
            ('nest_delays', 'wfsim_nest_delays', 'table_samplers.cu',
             'wfsim_tpu/models/s1.py:108')):
        measured(name, cu, rep, [entry], launches_d, dtimes[name])
    for name, entry, rep in (
            ('custom_delays', 'wfsim_s1_custom_delays',
             'wfsim_tpu/models/s1.py:56'),
            ('lumi_garfield_times', 'wfsim_lumi_garfield_times',
             'wfsim_tpu/models/s2.py:234'),
            ('lumi_garfield_times_confine', 'wfsim_lumi_garfield_times',
             'wfsim_tpu/models/s2.py:234')):
        measured(name, 'table_samplers.cu', rep, [entry], launches_t,
                 ttimes[name])
    measured('pulse_truth_per_pmt', 'pmt_response.cu',
             'wfsim_tpu/models/pmt.py:146', ['wfsim_pmt_row_truth_per_pmt'],
             launches_p, xtimes['pulse_truth_per_pmt'])
    measured('superpose_adc_full_no_he', 'superpose_adc.cu',
             'wfsim_tpu/pipeline/digitize.py:341; '
             'wfsim_tpu/pipeline/digitize.py:96',
             ['wfsim_superpose_adc_full'], launches_x,
             xtimes['superpose_adc_full_no_he'])
    print(f'[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s '
          f'after its start ({smi})')
    print(smi)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
