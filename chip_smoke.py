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

The second-to-last line is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: the kernel entries each main path must launch
DEFAULT_PATH_KERNELS = ('wfsim_superpose_adc', 'wfsim_zle_intervals',
                        'wfsim_pack_records')
REALISTIC_PATH_KERNELS = DEFAULT_PATH_KERNELS + (
    'wfsim_pmt_ap_select', 'wfsim_pmt_ap_emit', 'wfsim_ap_photon_summaries')


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
    """max |a - b| over matching outputs (float32 compared as values, -0.0
    and +0.0 apart by their bits); raises on a shape mismatch."""
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
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main():
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

    from wfsim_tpu_torch import Simulator, default_config
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
    for name, (ms, plain) in times.items():
        print(f'[kernels] {name}: {ms:.4f} ms, plain twin {plain:.4f} ms '
              f'({smi})')

    # ---- 4. main path ------------------------------------------------------
    inst = bench_instructions(512, 2000, 300)
    Simulator(cfg, device=dev).get_arrays(inst)          # warm-up
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
    peak = torch.cuda.max_memory_allocated(dev)
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
    L = int(params_r.noise_bank.shape[1])
    nix = torch.as_tensor(L - T // 2 + np.arange(B) * 7, dtype=torch.int32,
                          device=dev)           # every window wraps the bank
    nkw = dict(skw, noise_bank=params_r.noise_bank, noise_ix=nix,
               n_channels=C)
    grid_n = superpose_adc(*sargs, **nkw)
    grid_nr = superpose_adc_ref(*sargs, **nkw)
    err6 = max_diff(grid_n, grid_nr)
    in_win = grid_nr[(grid_nr > 15900) & (grid_nr < 16100)].to(torch.float32)
    print(f'[kernels-r] superpose_adc+noise: noise_ix {nix[0].item()}.. of '
          f'L={L}, differing samples {int((grid_n != grid_nr).sum())}, '
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
    for name in ('pmt_afterpulse', 'ap_photon_summaries',
                 'superpose_adc_noise'):
        ms, plain = times[name]
        print(f'[kernels-r] {name}: {ms:.4f} ms, plain twin {plain:.4f} ms '
              f'({smi})')
    del ph_ap, draws, ap_k, ap_r, grid_n, grid_nr

    # ---- 4b. realistic main path -----------------------------------------
    Simulator(cfg_r, device=dev).get_arrays(inst)        # warm-up
    torch.cuda.synchronize()
    for k in _build.KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    sim = Simulator(cfg_r, device=dev)
    t0 = time.perf_counter()
    out = sim.get_arrays(inst)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    launches_r = {name: k.launches for name, k in _build.KERNELS.items()}
    peak_r = torch.cuda.max_memory_allocated(dev)
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

    src = 'wfsim_tpu_torch/csrc/'
    rows = [
        dict(name='superpose_adc', route='cuda', source=src + 'superpose_adc.cu',
             replaces='wfsim_tpu/ops/waveform.py:68; '
                      'wfsim_tpu/pipeline/digitize.py:67',
             launches=launches['wfsim_superpose_adc'],
             max_abs_err=max(err1, err6),
             ms=times['superpose_adc'][0], plain_ms=times['superpose_adc'][1]),
        dict(name='zle_intervals', route='cuda', source=src + 'zle_intervals.cu',
             replaces='wfsim_tpu/ops/zle.py:119',
             launches=launches['wfsim_zle_intervals'], max_abs_err=err2,
             ms=times['zle_intervals'][0], plain_ms=times['zle_intervals'][1]),
        dict(name='pack_records', route='cuda', source=src + 'pack_records.cu',
             replaces='wfsim_tpu/pipeline/digitize.py:471',
             launches=launches['wfsim_pack_records'], max_abs_err=err3,
             ms=times['pack_records'][0], plain_ms=times['pack_records'][1]),
        dict(name='pmt_afterpulse', route='cuda',
             source=src + 'pmt_afterpulse.cu',
             replaces='wfsim_tpu/models/afterpulse.py:56',
             launches=min(launches_r['wfsim_pmt_ap_select'],
                          launches_r['wfsim_pmt_ap_emit']),
             max_abs_err=err4, ms=times['pmt_afterpulse'][0],
             plain_ms=times['pmt_afterpulse'][1]),
        dict(name='ap_photon_summaries', route='cuda',
             source=src + 'pmt_afterpulse.cu',
             replaces='wfsim_tpu/models/afterpulse.py:184',
             launches=launches_r['wfsim_ap_photon_summaries'],
             max_abs_err=err5, ms=times['ap_photon_summaries'][0],
             plain_ms=times['ap_photon_summaries'][1]),
    ]
    print(smi)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
