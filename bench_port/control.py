"""The readings the limits of ``correct`` are set from, on the card.

    python3 bench_port/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <k>] \
        [--fault-seeds <k>] [--fault-seconds <s>]

runs the cell once a seed in this one process (the set-up is paid once
for the card and the kernels) and prints a JSON line a run: the
program's compared numbers (the readings the limits' lower ends come
from); for the first ``--control-seeds`` seeds also the control's (the
reference put in the program's place in the precision below the
configuration's: a bfloat16 superposition for the records, S2 electrons
and photons drawn with bfloat16 probabilities and yield); then, on the
first ``--fault-seeds`` seeds, each group of ``FAULTS`` planted in the
program's configuration, held to the same reference.  The benchmark's own
runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: faults planted in the program's configuration alone, in groups that
#: move disjoint numbers (each group's comment names the numbers it is
#: read for): PMT afterpulses off (K11 emits nothing), the electron
#: lifetime ignored, the S1 yield without its 1 / (1 + p_dpe), the gate's
#: drift time ignored; electron afterpulses off, longitudinal diffusion off
FAULTS = {
    # pmt_ap_z, s2_electrons_z, s1_photons_z, electron_time_z
    'a': dict(enable_pmt_afterpulses=False, electron_lifetime_liquid=1e30,
              s1_detection_efficiency=0.12 * 1.219, drift_time_gate=0.0),
    # ele_ap_z, electron_spread_z
    'b': dict(enable_electron_afterpulses=False,
              diffusion_constant_longitudinal=0.0),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control-seeds', type=int, default=3)
    ap.add_argument('--fault-seeds', type=int, default=0)
    ap.add_argument('--fault-seconds', type=float, default=None)
    args = ap.parse_args(argv)
    from bench_port import harness
    import torch
    if not torch.cuda.is_available():
        print('control.py measures the card: no CUDA device',
              file=sys.stderr)
        return 3
    runs = [(seed, None, i < args.control_seeds)
            for i, seed in enumerate(args.seeds)]
    runs += [(seed, group, False) for seed in args.seeds[:args.fault_seeds]
             for group in FAULTS]
    for seed, group, control in runs:
        seconds = (args.seconds if group is None or args.fault_seconds is None
                   else args.fault_seconds)
        out = harness.run_cell(args.workload, seed, seconds, False,
                               control=control,
                               fault_config=FAULTS.get(group))
        got = dict(seed=seed, fault=group, correct=out['correct'],
                   checks={k: v['value'] for k, v in out['checks'].items()},
                   compared={k: v for k, v in out['compared'].items()
                             if k != 'control'},
                   events_per_s=out['metrics']['events_per_s']['value'])
        if 'control' in out['compared']:
            got['control'] = {k: v['value'] for k, v in
                              out['compared']['control'].items()}
        print(json.dumps(got), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
