"""Profiling helpers: host cProfile and device traces.

Port of the JAX package's ``utils/profiling.py``. The reference exposes
OCR-D's --profile/--profile-file (cProfile) on every processor CLI; here
the same host profiling is available, plus ``torch.profiler`` traces of
the host and the CUDA device written as Chrome traces (the JAX package
writes ``jax.profiler`` traces of the TPU): ``--torch-trace DIR`` on
``scripts/proc.py`` and ``scripts/eval.py``.
"""

import contextlib
import cProfile
import os
import pstats
import socket
import sys
import time

import torch


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
    """Optionally wrap a block in cProfile and/or a device trace.

    With `profile` the 30 costliest calls go to stderr, with
    `profile_file` the stats to that file; `trace_dir` writes a
    ``torch.profiler`` Chrome trace there. With `logger`, the block's wall
    time is logged, after the CUDA device (where one was used) finished
    its work."""
    prof = None
    trace_ctx = (_device_trace(trace_dir) if trace_dir
                 else contextlib.nullcontext())
    if profile or profile_file:
        prof = cProfile.Profile()
        prof.enable()
    t0 = time.perf_counter()
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
                logger.info('wall time: %.2fs', dt)


class PhaseTimer:
    """Per-phase wall-clock accounting (encode / decode / align / io)."""

    def __init__(self, logger=None):
        self.logger = logger
        self.totals = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + \
                time.perf_counter() - t0

    def report(self):
        lines = ['phase timing:']
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            lines.append('  %-12s %8.2fs' % (name, total))
        text = '\n'.join(lines)
        if self.logger:
            self.logger.info('%s', text)
        return text
