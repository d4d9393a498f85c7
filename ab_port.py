#!/usr/bin/env python3
"""A/B of two checkouts of wfsim_tpu_torch on one card.

    python3 ab_port.py OTHER_TREE [--runs 3]
        [--kernels [--only ap_diffuse|lumi_summaries|pmt_truth|
                           pmt_truth_layouts]]

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
the diffused pattern on their bench and skewed batches, and the
luminescence tables and the photon summaries on theirs, each against its
twin (and, where there is one, its library computation), and prints
``{row: {ms, device_ms, split, host_us, plain_ms, library_ms, ...}}``.
``--only ap_diffuse`` measures only the afterpulse generator and the
diffused pattern (``ap_diffuse_measure``), ``--only lumi_summaries`` only
the luminescence tables and the summaries (``lumi_summaries_measure``),
``--only pmt_truth`` only the row truth and the per-PMT truth
(``pmt_truth_measure``), ``--only pmt_truth_layouts`` the truth kernels
under each layout and chunk they could take (``pmt_truth_layouts_measure``;
give this tree as OTHER_TREE to measure it in four processes).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

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
        'rows')
print(json.dumps({'smi': smi, 'rows': {
    k: {x: v[x] for x in keep if x in v} for k, v in rows.items()}}))
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('other', type=Path, help='the other checkout')
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--kernels', action='store_true',
                    help='measure the kernel rows, not the runs')
    ap.add_argument('--only', choices=('all', 'ap_diffuse', 'lumi_summaries',
                                       'pmt_truth', 'pmt_truth_layouts'),
                    default='all',
                    help='with --kernels: every row, the K11 and K12b rows '
                         'only, the K6 and K11-summaries rows only, the '
                         'K8 row-truth and K16 rows only, or those two '
                         'kernels under each layout')
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    trees = {'other': args.other.resolve(), 'this': here}
    for label in ('other', 'this', 'this', 'other'):
        root = trees[label]
        cmd = ([sys.executable, '-c', KERNEL_CODE, str(root),
                str(here / 'chip_smoke.py'), args.only] if args.kernels else
               [sys.executable, '-c', CODE, str(root), str(args.runs)])
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
        if args.kernels:
            sys.stderr.write(r.stdout)
        if r.returncode:
            sys.stderr.write(r.stdout + r.stderr[-4000:])
            raise SystemExit(r.returncode)
        print(json.dumps({'tree': label, 'path': str(root),
                          **json.loads(r.stdout.strip().splitlines()[-1])}))


if __name__ == '__main__':
    main()
