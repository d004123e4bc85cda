"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``portbench/workloads/<name>.json``: its configuration
(``portbench/configs/``), its traffic mix (``portbench/traffic/``) and
its entry (``portbench/entries/<entry>.py``), all found by name. The run
sets up (model, inputs, warm-up: ``setup_s``), measures for `--seconds`,
checks what the window produced against the plain reference, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced), then
``checks``. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read by ``portbench/metrics/``
from the spans of the window and from the profiler's trace of a few
units run after it.

No CUDA device, or fewer than the cell asks for: exit 2 and no result.
JAX, or the JAX package, loaded in the process: exit 3 and no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


class Context:
    """What a metric reader gets: the cell's files, the window's units
    (dicts with t0, t1, traced and what the entry records), the spans,
    the trace (None when untraced) and the times of the run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def units(self, traced=None):
        return [u for u in self.records
                if traced is None or u['traced'] == traced]


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(name):
    workload = harness.load_json('workloads', name)
    config = harness.load_json('configs', workload['config'])
    traffic = harness.load_json('traffic', workload['traffic'])
    entry = importlib.import_module('portbench.entries.'
                                    + harness.check_name(workload['entry'],
                                                         'entry'))
    return workload, config, traffic, entry


def measure(cell, seconds, min_units, trace_units, trace):
    """The window: units until `seconds` have passed and at least
    `min_units` units are done (the cell's inputs bound it: it ends
    early once they run out); then, when `trace`, `trace_units` more
    under the profiler (after the window, since the profiler slows the
    launches that follow it)."""
    import torch
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < seconds or done < min_units:
        if cell.run_unit(False) is None:
            break
        done += 1
    if cell.device.type == 'cuda':
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if not trace:
        return t0, t1, None
    profiler = harness.Profiler()
    profiler.start()
    cell.spans.annotate = True
    for _ in range(trace_units):
        if cell.run_unit(True) is None:
            break
    cell.spans.annotate = False
    profiler.stop()
    return t0, t1, profiler.trace()


def run(workload, config, traffic, entry, seed, seconds, trace, device,
        bench, chips):
    """One run of a cell; returns (result, checks). `device` is the
    torch device (a CUDA device in a benchmark run; the tests pass the
    CPU)."""
    import torch
    cell = entry.Cell(config, workload, traffic, seed, device)
    cell.setup()
    if device.type == 'cuda':
        torch.cuda.synchronize()
    # what set-up made stays: keep the collector from walking it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    t0, t1, tr = measure(cell, seconds, workload['min_window_units'],
                         workload['trace_units'], trace)
    dev_info = (harness.device_info(chips) if device.type == 'cuda'
                else {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                      'memory_peak_bytes': 0})
    records = cell.records
    cell.free()
    e2e, per_layer = harness.metric_specs(bench, workload['name'])
    specs = per_layer if trace else e2e
    ctx = Context(workload=workload, config=config, records=records,
                  spans=cell.spans, trace=tr, window=(t0, t1))
    metrics = {}
    for m in specs:
        harness.check_unit(m['unit'])
        value = (setup_s if m['name'] == 'setup_s'
                 else harness.load_reader(m['name'])(ctx))
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    t_check = time.perf_counter()
    checks, info = cell.check()
    info['check_s'] = round(time.perf_counter() - t_check, 3)
    # a unit that raises ends the run without a result: none has failed
    result = {'correct': all(c['value'] <= c['limit'] for c in checks),
              'attempted': len(records), 'failed': 0,
              'metrics': metrics, 'device': dev_info}
    if tr is not None:
        result['device']['busy_s'] = tr.busy_s()
        result['device']['window_s'] = tr.window_s()
        result['breakdown'] = tr.breakdown()
    units = ctx.units(False)
    if len(units) < workload['min_window_units']:
        # too few units for the cell's tail: the inputs ran out
        raise RuntimeError('the window holds %d units, the cell needs %d'
                           % (len(units), workload['min_window_units']))
    print('window %.3f s, %d units (%d traced), %s; set-up %.3f s (%s)'
          % (t1 - t0, len(units), len(ctx.units(True)),
             ', '.join('%s %s' % kv for kv in info.items()), setup_s,
             ', '.join('%s %.3f' % kv for kv in cell.phases.items())),
          file=sys.stderr)
    return result, checks


def finish(result, checks):
    """The run's last step: no result where JAX, or the JAX package,
    has been loaded into this process by anything the run did (the
    program, the readers, the reference); else the result line."""
    found = harness.forbidden_modules()
    if found:
        print('loaded in this process: %s' % ', '.join(found),
              file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


def main(argv=None):
    args = parse_args(argv)
    bench = harness.load_benchmark()
    cells = {w['name']: w for w in bench['workloads']}
    if args.workload not in cells:
        print('no workload %r in BENCHMARK.json' % args.workload,
              file=sys.stderr)
        return 2
    chips = cells[args.workload]['chips']
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('this cell needs %d CUDA device(s); %d visible'
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    workload, config, traffic, entry = load_cell(args.workload)
    limit = harness.power_limit()
    if limit:
        print('card: %s' % limit, file=sys.stderr)
    result, checks = run(workload, config, traffic, entry, args.seed,
                         args.seconds, bool(args.trace),
                         torch.device('cuda'), bench, chips)
    return finish(result, checks)


if __name__ == '__main__':
    sys.exit(main())
