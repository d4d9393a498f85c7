"""Run one cell of the benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It measures the card: without CUDA, or with
fewer cards than the cell asks for, it prints no result and exits 3.  The
last line of standard output is the result (JSON); the compared numbers
and their limits are the last lines of standard error and the result's
last key (``checks``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error('--seed must be a whole number >= 0')

    from bench_port import harness
    import torch
    bench = harness.load_benchmark()
    chips = int(harness.cell_of(bench, args.workload)['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'bench_port: the cell needs {chips} CUDA device(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'device_count() {torch.cuda.device_count()}',
              file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), bench=bench)
    for name, c in out['checks'].items():
        print(f'check {name}: {c["value"]} (limit {c["limit"]})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
