"""Profiling helpers: host cProfile, device traces, and the program's own
spans and counters.

Port of the JAX package's ``utils/profiling.py``. The reference exposes
OCR-D's --profile/--profile-file (cProfile) on every processor CLI; here
the same host profiling is available, plus ``torch.profiler`` traces of
the host and the CUDA device written as Chrome traces (the JAX package
writes ``jax.profiler`` traces of the TPU): ``--torch-trace DIR`` on
``scripts/proc.py``, ``scripts/eval.py`` and ``scripts/train.py``.

The tracer (`tracer`; `span`, `traced` and `count` below) marks the
layer boundaries of the program: the processor's phases, the API's
dispatch and finish, the decoders' encoder, beam iterations and
backtrace, the phases of a training step; and it counts the beam's
iterations and rows. It is on while a ``torch.profiler`` session runs in
the process, and inside a `maybe_profile` block given `profile`,
`profile_file` or `trace_dir`. On, each span is a ``cor.<name>``
annotation in the profiler's trace (when a profiler runs) and adds its
duration to in-memory totals by name; off, a span is one shared
do-nothing context and a count does nothing.
"""

import contextlib
import cProfile
import functools
import os
import pstats
import socket
import sys
import threading
import time

import torch

# the module whose flag says whether a torch.profiler session runs
_autograd_profiler = torch.autograd.profiler
# what `span` hands back while the tracer is off
_OFF = contextlib.nullcontext()


class _Span:
    """One open span of an active tracer."""

    __slots__ = ('tracer', 'name', 'note', 't0', 'child_s')

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.name = name
        self.note = None
        self.child_s = 0.0

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.note = torch.profiler.record_function('cor.' + self.name)
            self.note.__enter__()
        self.tracer._stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.note is not None:
            self.note.__exit__(*exc)
        stack = self.tracer._stack()
        stack.pop()
        if stack:
            stack[-1].child_s += dt
        self.tracer._add(self.name, dt, dt - self.child_s)
        return False


def profiler_running():
    """Whether a ``torch.profiler`` session runs in the process."""
    return bool(_autograd_profiler._is_profiler_enabled)


class Tracer:
    """Spans and counters of the program, aggregated in memory by name:
    for each span its count, total seconds and self seconds (its time
    less that of the spans opened inside it on the same thread), on the
    host clock of ``time.perf_counter``; for each counter its sum.

    The record starts empty each time the tracer turns on: when a
    `maybe_profile` block starts, and at the first span, count or
    snapshot that finds a profiler session running after one that found
    none (the end of a `maybe_profile` block is such a look)."""

    def __init__(self):
        self._forced = 0
        self._live = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._reset()

    def _reset(self):
        with self._lock:
            self.spans = {}
            self.counters = {}

    def _stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name, total_s, self_s):
        with self._lock:
            agg = self.spans.get(name)
            if agg is None:
                agg = self.spans[name] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += total_s
            agg[2] += self_s

    def _begin(self):
        """Turn on for a `maybe_profile` block, with an empty record."""
        self._forced += 1
        self._live = True
        self._reset()

    def _end(self):
        """After a `maybe_profile` block: off again unless a profiler
        session still runs, so that the next one starts empty."""
        self._forced -= 1
        self.active()

    def active(self):
        """Whether the tracer records now; a turn from off to on empties
        the record."""
        on = self._forced > 0 or profiler_running()
        if on != self._live:
            self._live = on
            if on:
                self._reset()
        return on

    def span(self, name):
        """A context manager around one phase `name` (``layer.phase``)."""
        if not self.active():
            return _OFF
        return _Span(self, name)

    def traced(self, name):
        """A decorator that runs each call of a function in `span(name)`."""
        def wrap(fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)
            return wrapped
        return wrap

    def count(self, name, n=1):
        """Add `n` to the counter `name` while the tracer is on."""
        if self.active():
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self):
        """The record: ``{'spans': {name: {'count', 'total_s',
        'self_s'}}, 'counters': {name: sum}}``."""
        self.active()
        with self._lock:
            return {'spans': {name: {'count': c, 'total_s': t, 'self_s': s}
                              for name, (c, t, s) in self.spans.items()},
                    'counters': dict(self.counters)}

    def report(self):
        """The spans' totals, longest first, and the counters, as text."""
        snap = self.snapshot()
        lines = ['span timing:']
        for name, agg in sorted(snap['spans'].items(),
                                key=lambda kv: -kv[1]['total_s']):
            lines.append('  %-24s %8.2fs  self %8.2fs  %8d calls'
                         % (name, agg['total_s'], agg['self_s'],
                            agg['count']))
        for name, n in sorted(snap['counters'].items()):
            lines.append('  %-24s %d' % (name, n))
        return '\n'.join(lines)


# the process's tracer: it follows the process's profiler sessions
tracer = Tracer()
span = tracer.span
traced = tracer.traced
count = tracer.count
snapshot = tracer.snapshot
report = tracer.report


def _synchronize():
    """Wait for the CUDA device, where the block used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def _device_trace(trace_dir):
    """Trace the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity where CUDA is available) and write it as a Chrome trace
    ``<host>_<pid>.<ns>.pt.trace.json`` into `trace_dir`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, '%s_%d.%d.pt.trace.json'
        % (socket.gethostname(), os.getpid(), time.time_ns())))


@contextlib.contextmanager
def maybe_profile(profile=False, profile_file=None, trace_dir=None,
                  logger=None):
    """Optionally wrap a block in cProfile and/or a device trace, with the
    tracer on.

    With `profile` the 30 costliest calls go to stderr, with
    `profile_file` the stats to that file; `trace_dir` writes a
    ``torch.profiler`` Chrome trace there, in which the program's spans
    are ``cor.*`` annotations beside the device's kernels. With any of
    the three the tracer records the block from an empty record. With
    `logger`, the block's wall time is logged, after the CUDA device
    (where one was used) finished its work, and with the tracer on the
    tracer's `report` in the same record."""
    prof = None
    trace_ctx = (_device_trace(trace_dir) if trace_dir
                 else contextlib.nullcontext())
    tracing = bool(profile or profile_file or trace_dir)
    if tracing:
        tracer._begin()
    if profile or profile_file:
        prof = cProfile.Profile()
        prof.enable()
    t0 = time.perf_counter()
    try:
        with trace_ctx:
            try:
                yield
            finally:
                _synchronize()
                dt = time.perf_counter() - t0
                if prof is not None:
                    prof.disable()
                    if profile_file:
                        prof.dump_stats(profile_file)
                    else:
                        stats = pstats.Stats(prof, stream=sys.stderr)
                        stats.sort_stats('cumulative').print_stats(30)
                if logger is not None:
                    if tracing:
                        logger.info('wall time: %.2fs\n%s', dt,
                                    tracer.report())
                    else:
                        logger.info('wall time: %.2fs', dt)
    finally:
        if tracing:
            tracer._end()
