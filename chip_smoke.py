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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'kernel {name} not launched on the main path')
    if len(truth) != len(inst):
        raise AssertionError(f'truth rows {len(truth)} != {len(inst)}')
    if not (len(rr) and np.all(np.diff(rr['time']) >= 0)
            and rr['length'].max() <= 110 and rr['channel'].max() < C
            and rr['channel'].min() >= 0 and rr['data'].min() >= 0
            and np.all(rr['pulse_length'] >= rr['length'])):
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
    batch, T_cap, pieces = max(batches, key=lambda b: (b[1], len(b[0])))
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

    src = 'wfsim_tpu_torch/csrc/'
    rows = [
        dict(name='superpose_adc', route='cuda', source=src + 'superpose_adc.cu',
             replaces='wfsim_tpu/ops/waveform.py:68',
             launches=launches['wfsim_superpose_adc'], max_abs_err=err1,
             ms=times['superpose_adc'][0], plain_ms=times['superpose_adc'][1]),
        dict(name='zle_intervals', route='cuda', source=src + 'zle_intervals.cu',
             replaces='wfsim_tpu/ops/zle.py:119',
             launches=launches['wfsim_zle_intervals'], max_abs_err=err2,
             ms=times['zle_intervals'][0], plain_ms=times['zle_intervals'][1]),
        dict(name='pack_records', route='cuda', source=src + 'pack_records.cu',
             replaces='wfsim_tpu/pipeline/digitize.py:471',
             launches=launches['wfsim_pack_records'], max_abs_err=err3,
             ms=times['pack_records'][0], plain_ms=times['pack_records'][1]),
    ]
    print(smi)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
