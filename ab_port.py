#!/usr/bin/env python3
"""A/B of two checkouts of wfsim_tpu_torch on one card.

    python3 ab_port.py OTHER_TREE [--runs 3]
        [--kernels [--only ap_diffuse|lumi_summaries|pmt_truth|
                           pmt_truth_layouts|photon_times|step_block|
                           garfield|s1_delays|s1_times|record_rows|
                           window_rows]]
        [--own] [--configs [NAME,...]] [--busy]

Runs the 512-event bench workload in the default and the realistic
configuration in four fresh processes, in turns: OTHER_TREE, this tree,
this tree, OTHER_TREE (each builds its own kernels under its own
``build/``). Each process does one warm-up run and ``--runs`` timed runs
of ``Simulator(cfg).get_arrays(inst)`` per configuration and prints one
JSON line: the tree, wall seconds, events/s, records and truth rows.

With ``--kernels`` each process measures kernel rows instead, with this
tree's ``chip_smoke.kernel_rows`` on the tree's own package: the
superposition entries on their three window batches, the ZLE and record
pack on four grids, the per-PMT truth, the PMT-afterpulse generator and
the diffused pattern on their bench and skewed batches, the luminescence
tables and the photon summaries, the truth kernels and the gas-gap and
S2 photon times on theirs, the step's channel block, the garfield times
and the custom and NEST S1 delays on theirs, each against its
twin (and, where there is one, its library computation), and prints
``{row: {ms, device_ms, split, host_us, plain_ms, library_ms, ...}}``.
``--only ap_diffuse`` measures only the afterpulse generator and the
diffused pattern (``ap_diffuse_measure``), ``--only lumi_summaries`` only
the luminescence tables and the summaries (``lumi_summaries_measure``),
``--only pmt_truth`` only the row truth and the per-PMT truth
(``pmt_truth_measure``), ``--only pmt_truth_layouts`` the truth kernels
under each layout and chunk they could take (``pmt_truth_layouts_measure``;
give this tree as OTHER_TREE to measure it in four processes), and
``--only photon_times`` only the gas-gap luminescence times and the S1,
S2 electron and S2 photon times (``photon_times_measure``), ``--only
step_block`` only the step's channel block on the step shard and its
skewed and burst copies (``step_block_measure``), ``--only garfield``
only the garfield wire-table times on the timing_models S2 batch in both
modes and its skewed copy (``garfield_measure``), and ``--only
s1_delays`` only the custom S1 delays on the timing_models S1 batch and
the NEST S1 delays on the detector_physics one, each also on a copy whose
instruction 100 holds 10^5 photons (``s1_delays_measure``), and ``--only
s1_times`` only the S1 photon times on the default S1 batch, its copy
whose instruction 100 holds 10^5 photons, and the timing_models and
detector_physics S1 batches given their delays (``s1_times_measure``),
and ``--only record_rows`` the record rows (K4r) on the default run's
first round and that round's copy into the record arena
(``record_rows_measure``; a checkout without K4r has no such row), and
``--only window_rows`` the arena gather and channel extents (K17) on the
bench batch, its skewed copy and the default run's largest digitize batch
(``window_rows_measure``; a checkout without K17 has no such row).
With ``--own`` each tree is measured by its own ``chip_smoke.py`` (for
rows whose measurement changed with the kernels, as ``record_rows``
did when the round ordering became a kernel).

With ``--configs`` each process runs, with this tree's
``chip_smoke.config_runs`` on the tree's own package, each of the ten
configurations of ``chip_smoke.RUN_CONFIGS`` (or the comma-separated
names given) on its 512-event workload, a warm-up then a timed run, and
prints per configuration the wall seconds, events/s, records, the raw
data's Timers, the peak device memory and VmRSS after the run.  With
``--busy`` each process runs the default configuration once to warm up
and prints ``chip_smoke.device_busy`` of one more run: the device's busy
share of a warm run's wall time.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

#: chip_smoke.RUN_CONFIGS (this script does not import chip_smoke)
RUN_CONFIGS = ('default', 'realistic', 'detector_physics', 'he_full_grid',
               'timing_models', 'per_pmt_truth', 'xenon1t_full_grid',
               'field_maps', 'optical_nveto', 'optical_tpc')

CODE = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from wfsim_tpu_torch import Simulator, default_config, _build
from wfsim_tpu_torch.interface import bench_instructions
_build.build()
inst = bench_instructions(512, 2000, 300)
realism = dict(enable_noise=True, enable_pmt_afterpulses=True,
               enable_electron_afterpulses=True)
res = {}
for name, kw in (('default', {}), ('realistic', realism)):
    cfg = default_config(seed=1234, chunk_size=100, **kw)
    Simulator(cfg, device='cuda').get_arrays(inst)
    walls = []
    for _ in range(int(sys.argv[2])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = Simulator(cfg, device='cuda').get_arrays(inst)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    res[name] = dict(walls=walls, ev_s=[512 / w for w in walls],
                     records=len(out['raw_records']),
                     truth=len(out['truth']))
print(json.dumps(res))
'''

KERNEL_CODE = r'''
import importlib.util, json, subprocess, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
from wfsim_tpu_torch import _build
_build.build()
smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                      '--format=csv,noheader'], capture_output=True,
                     text=True).stdout.strip()
dev = torch.device('cuda:0')
rows = (cs.kernel_rows(dev, smi) if sys.argv[3] == 'all' else
        getattr(cs, sys.argv[3] + '_measure')(dev, smi, max_syncs=None))
keep = ('ms', 'device_ms', 'split', 'host_us', 'plain_ms', 'library_ms',
        'library_call', 'library_calls', 'bytes', 'ops32', 'ops64',
        'library_diff', 'syncs', 'photons', 'seq_rows', 'second_pass',
        'rows', 'bytes_old', 'device_call_ms', 'kept', 'windows', 'records',
        'max_window', 'sort_ms', 'round_records_ms', 'bound_rows_ms')
print(json.dumps({'smi': smi, 'rows': {
    k: {x: v[x] for x in keep if x in v} for k, v in rows.items()}}))
'''

RUNS_CODE = r'''
import importlib.util, json, subprocess, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location('chip_smoke', sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
from wfsim_tpu_torch import Simulator, _build, default_config
from wfsim_tpu_torch.interface import bench_instructions
_build.build()
smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                      '--format=csv,noheader'], capture_output=True,
                     text=True).stdout.strip()
dev = torch.device('cuda:0')
if sys.argv[3] == 'busy':
    inst = bench_instructions(512, 2000, 300)
    cfg = default_config(seed=1234, chunk_size=100)
    run = lambda: Simulator(cfg, device=dev).get_arrays(inst)
    run()
    out = dict(busy=cs.device_busy(run))
else:
    out = dict(runs=cs.config_runs(dev, smi, sys.argv[3].split(',')))
print(json.dumps(dict(smi=smi, **out)))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('other', type=Path, help='the other checkout')
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--kernels', action='store_true',
                    help='measure the kernel rows, not the runs')
    ap.add_argument('--only', choices=('all', 'ap_diffuse', 'lumi_summaries',
                                       'pmt_truth', 'pmt_truth_layouts',
                                       'photon_times', 'step_block',
                                       'garfield', 's1_delays', 's1_times',
                                       'record_rows', 'window_rows'),
                    default='all',
                    help='with --kernels: every row, the K11 and K12b rows '
                         'only, the K6 and K11-summaries rows only, the '
                         'K8 row-truth and K16 rows only, those two '
                         'kernels under each layout, the K13a and K9 '
                         'rows only, the K14 rows only, the K13c rows '
                         'only, the K15 and K13b rows only, the K9 S1 '
                         'rows only, the K4r row only, or the K17 rows '
                         'only')
    ap.add_argument('--own', action='store_true',
                    help="with --kernels: each tree's own chip_smoke.py")
    ap.add_argument('--configs', nargs='?', const='all', default=None,
                    help='run the configurations (all of RUN_CONFIGS, or '
                         'the comma-separated names), not the bench runs')
    ap.add_argument('--busy', action='store_true',
                    help="measure the default run's device busy share")
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    trees = {'other': args.other.resolve(), 'this': here}
    for label in ('other', 'this', 'this', 'other'):
        root = trees[label]
        smoke = str((root if args.own else here) / 'chip_smoke.py')
        if args.kernels:
            cmd = [sys.executable, '-c', KERNEL_CODE, str(root), smoke,
                   args.only]
        elif args.configs or args.busy:
            names = ('busy' if args.busy else ','.join(RUN_CONFIGS)
                     if args.configs == 'all' else args.configs)
            cmd = [sys.executable, '-c', RUNS_CODE, str(root), smoke, names]
        else:
            cmd = [sys.executable, '-c', CODE, str(root), str(args.runs)]
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
        if args.kernels or args.configs or args.busy:
            sys.stderr.write(r.stdout)
        if r.returncode:
            sys.stderr.write(r.stdout + r.stderr[-4000:])
            raise SystemExit(r.returncode)
        print(json.dumps({'tree': label, 'path': str(root),
                          **json.loads(r.stdout.strip().splitlines()[-1])}))


if __name__ == '__main__':
    main()
