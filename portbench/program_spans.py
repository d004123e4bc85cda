"""The program's own spans in a traced run: the ``cor.*`` annotations
that the tracer of ``cor_asv_ann_tpu_torch/utils/profiling.py`` puts into
the profiler's trace, and the device's idle time split among them.

Idle time is the traced window less the union of the device's activity
(`harness.Trace.busy_intervals`). It is split exactly at span
boundaries: each stretch of it goes to the innermost ``cor.*`` span that
covers it (the shortest; spans of one thread nest), or to no span.
A program without such spans gives none, and the readers then read
nothing.
"""

import functools
import heapq

PREFIX = 'cor.'


def spans(trace):
    """The ``cor.*`` annotations of `trace` that meet its window, clipped
    to it: (name without the prefix, start, end) in microseconds."""
    lo, hi = trace.window
    out = []
    for name, s, e in trace.host:
        if name.startswith(PREFIX) and e > lo and s < hi:
            out.append((name[len(PREFIX):], max(s, lo), min(e, hi)))
    return out


def idle_intervals(trace):
    """The stretches of the window in which the device was idle."""
    lo, hi = trace.window
    gaps, last = [], lo
    for s, e in trace.busy_intervals():
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if hi > last:
        gaps.append((last, hi))
    return gaps


@functools.lru_cache(maxsize=1)
def idle_by_innermost(trace):
    """(idle microseconds by the name of the innermost ``cor.*`` span
    over them, None for those under no such span; the total idle
    microseconds), or None where the trace holds no ``cor.*`` span."""
    marks = spans(trace)
    if not marks:
        return None
    gaps = idle_intervals(trace)
    points = sorted({p for _, s, e in marks for p in (s, e)}
                    | {p for s, e in gaps for p in (s, e)})
    order = sorted(range(len(marks)), key=lambda i: marks[i][1])
    heap, nxt, g = [], 0, 0
    out = {}
    for a, b in zip(points, points[1:]):
        while nxt < len(order) and marks[order[nxt]][1] <= a:
            i = order[nxt]
            _, s, e = marks[i]
            heapq.heappush(heap, (e - s, -s, i))
            nxt += 1
        while heap and marks[heap[0][2]][2] <= a:
            heapq.heappop(heap)
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g < len(gaps) and gaps[g][0] <= a:
            name = marks[heap[0][2]][0] if heap else None
            out[name] = out.get(name, 0.0) + (b - a)
    return out, sum(e - s for s, e in gaps)


def idle_share_of_layer(trace, layer):
    """The share of the window's idle time whose innermost ``cor.*`` span
    lies in `layer` (``cor.<layer>.*``), or None."""
    split = idle_by_innermost(trace) if trace is not None else None
    if split is None or split[1] <= 0:
        return None
    by_name, total = split
    return sum(v for n, v in by_name.items()
               if n is not None and n.split('.')[0] == layer) / total


def idle_share_under(trace, name):
    """The share of the window's idle time inside a ``cor.<name>`` span,
    the spans opened inside it included, or None."""
    if trace is None:
        return None
    under = sorted((s, e) for n, s, e in spans(trace) if n == name)
    gaps = idle_intervals(trace)
    total = sum(e - s for s, e in gaps)
    if not under or total <= 0:
        return None
    merged = []
    for s, e in under:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    covered, i = 0.0, 0
    for s, e in gaps:
        while i < len(merged) and merged[i][1] <= s:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < e:
            covered += min(e, merged[j][1]) - max(s, merged[j][0])
            j += 1
    return covered / total


def durations_ms(trace, name):
    """The durations of the ``cor.<name>`` spans in the window, in ms."""
    if trace is None:
        return []
    return [(e - s) * 1e-3 for n, s, e in spans(trace) if n == name]


def tracer_snapshot():
    """The program tracer's record of the traced units, or None where
    the program has no tracer."""
    from cor_asv_ann_tpu_torch.utils import profiling
    tracer = getattr(profiling, 'tracer', None)
    return tracer.snapshot() if tracer is not None else None
