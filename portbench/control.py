"""Readings of a cell's comparison: the program's and the control's.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] \
        [--units <n>]

For each seed, in one process: the cell's set-up, a short window of
`--units` units at the cell's own load (pages: enough for the sample; a
training cell needs none, its readings are of set-up's first steps),
then the numbers that decide ``correct`` as the program gives them, and
as the control gives them: the reference computed in the next precision
below the configuration's (float32 with TF32 off -> TF32), put in the
program's place; or, with ``--fault``, the program's with that fault
of ``portbench/faults.py`` planted. One JSON line a seed. The
benchmark's own runs never run this; the limits in
``portbench/workloads/`` are set from its readings (PERF.md).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults, run  # noqa: E402


def readings(name, seed, units, device, fault=None):
    workload, config, traffic, entry = run.load_cell(name)
    patch = faults.Patch()
    if fault:
        getattr(faults, fault)(patch)
    if units:
        # the sample is drawn among the pages of the short window
        workload = dict(workload, min_window_units=units,
                        pages=units + workload['trace_units'])
    cell = entry.Cell(config, workload, traffic, seed, device)
    cell.setup()
    for _ in range(units):
        if cell.run_unit(False) is None:
            break
    checks, info = cell.check()
    patch.undo()
    program = {c['name']: c['value'] for c in checks}
    limits = {c['name']: c['limit'] for c in checks}
    control = None if fault else cell.control()
    cell.free()
    return dict(workload=name, seed=seed, fault=fault, program=program,
                control=control, limits=limits, info=info)


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--units', type=int, default=0)
    ap.add_argument('--fault', choices=faults.PAGES + faults.TRAIN,
                    help='plant this fault (portbench/faults.py) and read '
                    'the program alone')
    args = ap.parse_args(argv)
    for seed in args.seeds:
        line = readings(args.workload, seed, args.units,
                        torch.device('cuda'), args.fault)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
