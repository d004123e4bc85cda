"""What every cell of the port's benchmark shares.

- finding the benchmark's files by name, and checking names and units;
- spans: host-clock intervals recorded around the benchmark's own calls
  into the program;
- the device's trace: ``torch.profiler`` over a part of the window,
  reduced to kernel intervals, host activity and annotations;
- the result line and the checks printed beside it;
- the look for JAX in the process, and the device's description.
"""

import contextlib
import json
import os
import re
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT_RE = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
# top-level module names that may not be loaded in a run
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'cor_asv_ann_tpu')
# the kinds of device activity in a torch.profiler Chrome trace
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'user_annotation',
             'python_function', 'cuda_driver')


def check_name(name, what):
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError('%s %r is not a valid name' % (what, name))
    return name


def check_unit(unit):
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError('unit %r is not valid' % (unit,))
    return unit


def load_json(kind, name):
    """``portbench/<kind>/<name>.json``."""
    check_name(name, kind)
    with open(os.path.join(BENCH_DIR, kind, name + '.json'),
              encoding='utf-8') as f:
        return json.load(f)


def load_benchmark():
    with open(os.path.join(ROOT, 'BENCHMARK.json'), encoding='utf-8') as f:
        return json.load(f)


def metric_specs(bench, workload):
    """The end-to-end and per-layer metrics a cell reports:
    (end_to_end, per_layer) lists of metric entries."""
    def applies(m):
        return workload in m.get('workloads', [workload])
    return ([m for m in bench['end_to_end'] if applies(m)],
            [m for m in bench['per_layer'] if applies(m)])


def reader_path(name):
    """``portbench/metrics/<name>.py``, else the file of the part of the
    name before its first dot (one reader for a quantity whose cells
    report it under several names)."""
    check_name(name, 'metric')
    for stem in (name, name.split('.')[0]):
        path = os.path.join(BENCH_DIR, 'metrics', stem + '.py')
        if os.path.exists(path):
            return path
    raise FileNotFoundError('no reader for metric %r' % name)


def load_reader(name):
    import importlib.util
    path = reader_path(name)
    modname = 'portbench.metrics._' + re.sub(r'\W', '_', name)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host-clock spans (seconds of ``time.perf_counter``) in memory.
    While `annotate` is set (the traced units), each span is also a
    ``portbench.<name>`` annotation in the profiler's trace, so that the
    device's idle gaps can be named by the span under them."""

    def __init__(self):
        self.items = []
        self.annotate = False

    def add(self, name, t0, t1, **info):
        self.items.append(dict(name=name, t0=t0, t1=t1, **info))

    def of(self, name):
        return [s for s in self.items if s['name'] == name]

    @contextlib.contextmanager
    def span(self, name, **info):
        note = None
        if self.annotate:
            import torch
            note = torch.profiler.record_function('portbench.' + name)
            note.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if note is not None:
                note.__exit__(None, None, None)
            self.add(name, t0, t1, **info)

    def timed(self, name, fn, **info):
        """Wrap `fn` so that each call records a span `name`."""
        def wrapped(*args, **kwargs):
            with self.span(name, **info):
                return fn(*args, **kwargs)
        return wrapped


class Trace:
    """The device activity and host activity of a traced window, in
    microseconds of the profiler's clock: `device` and `host` are lists
    of (name, start, end); `window` is (start, end) of the annotation
    that bounds the traced work."""

    def __init__(self, device, host, window):
        self.device = device
        self.host = host
        self.window = window

    @classmethod
    def from_chrome(cls, events, window_name):
        device, host, window = [], [], None
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            start = float(e['ts'])
            end = start + float(e.get('dur', 0.0))
            if cat in DEVICE_CATS:
                device.append((e.get('name', ''), start, end, cat))
            elif cat in HOST_CATS:
                if e.get('name') == window_name and cat == 'user_annotation':
                    window = (start, end)
                host.append((e.get('name', ''), start, end))
        if window is None:
            raise RuntimeError('the trace holds no %r annotation'
                               % window_name)
        lo, hi = window
        device = [d for d in device if d[2] > lo and d[1] < hi]
        return cls(device, host, window)

    def kernels(self):
        return [d for d in self.device if d[3] == 'kernel']

    def busy_intervals(self):
        """The union of device activity clipped to the window, merged."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.device)
        merged = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    def breakdown(self, top=10):
        """The device operations that took the most time, and the longest
        idle gaps of the window, each named by the innermost host
        activity under its middle."""
        total = {}
        for name, s, e, _ in self.device:
            total[name] = total.get(name, 0.0) + (e - s) * 1e-6
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        gaps, last = [], lo
        for s, e in self.busy_intervals() + [[hi, hi]]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        named = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            under = [h for h in host if h[1] <= mid <= h[2]
                     and (h[1], h[2]) != tuple(self.window)]
            name = (min(under, key=lambda h: h[2] - h[1])[0] if under
                    else 'between units')
            named.append([name, (e - s) * 1e-6])
        return {'device_ops': [[n, v] for n, v in ops], 'idle_gaps': named}


class Profiler:
    """torch.profiler over the CPU and CUDA activity of a part of the
    window; its trace goes through a temporary file in TMPDIR and is
    deleted once read."""

    WINDOW = 'portbench.traced'

    def __init__(self):
        import torch
        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.annotation = None

    def start(self):
        self.prof.__enter__()
        self.annotation = self.torch.profiler.record_function(self.WINDOW)
        self.annotation.__enter__()

    def stop(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.annotation.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def trace(self):
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding='utf-8') as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get('traceEvents', [])
        return Trace.from_chrome(events, self.WINDOW)


def forbidden_modules():
    """The forbidden top-level module names loaded in this process."""
    loaded = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def device_info(n):
    import torch
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(n))
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': n, 'memory_peak_bytes': int(peak)}


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def emit(result, checks):
    """Print the checks as the last lines of standard error and the
    result as the last line of standard output, the checks under a key
    of their own that comes last."""
    for c in checks:
        print('check %s %r limit %r' % (c['name'], c['value'], c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line['checks'] = checks
    print(json.dumps(line), flush=True)
