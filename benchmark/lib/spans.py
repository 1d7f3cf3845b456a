"""The program's own spans in a traced run, on plain tuples.

The program opens a ``torch.profiler`` range at each layer boundary while
a profiler records (``primme_tpu_torch.core.linalg.scope``): ``pt_eigsh``
around ``eigsh``, ``pt_inner`` around an inner solve, ``pt_refine`` around
``refine_eigsh``, ``pt_to_host`` around the results' copies to numpy, and
a ``pt_read`` at every wait for the card (``core.linalg.host_read``).
Their host spans share the device events' clock, so the device's idle time
inside a span is the span's length less the device's busy time in it.

A span or a device event is ``(name, start_us, end_us)``. Each reader
returns None where the trace holds no span of the name it reads, as a
program without these spans gives.
"""

from __future__ import annotations

import bisect

from . import trace as T


def of(spans, name: str):
    """The ``(start, end)`` of the spans named ``name``."""
    return [(a, b) for n, a, b in spans if n == name]


def overlap_us(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint
    ``(start, end)`` intervals."""
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_inside_us(events, spans, lo: float, hi: float) -> float:
    """The device's idle time inside the union of ``spans`` (``(start,
    end)``) clipped to ``[lo, hi]``: its length less the time in it in
    which a device event ran (``trace.busy_us``'s union of events)."""
    inside = T.merged(T.clip(spans, lo, hi))
    busy = T.merged([(e[1], e[2]) for e in events])
    return sum(b - a for a, b in inside) - overlap_us(inside, busy)


def inside(spans, outer):
    """The ``(start, end)`` of ``spans`` that lie inside one of the
    ``outer`` intervals."""
    out = T.merged(outer)
    starts = [a for a, _ in out]
    got = []
    for a, b in spans:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= out[i][1]:
            got.append((a, b))
    return got


def _per_call(run, value):
    return None if value is None or not run["calls"] else \
        value / len(run["calls"])


def idle_ms(run, name: str):
    """Device idle milliseconds a call inside the ``name`` spans, within
    the traced window."""
    lo, hi = run["window_us"]
    got = of(run["trace"]["host_spans"], name)
    if lo is None or not got:
        return None
    return _per_call(run, idle_inside_us(run["trace"]["device"], got, lo, hi)
                     / 1e3)


def count_in(run, name: str, outer: str):
    """The ``name`` spans inside ``outer`` spans, a call."""
    spans = run["trace"]["host_spans"]
    top = of(spans, outer)
    if not top:
        return None
    return _per_call(run, len(inside(of(spans, name), top)))


def host_ms_in(run, name: str, outer: str):
    """Host milliseconds a call of the ``name`` spans inside ``outer``
    spans."""
    spans = run["trace"]["host_spans"]
    top, got = of(spans, outer), of(spans, name)
    if not top or not got:
        return None
    return _per_call(run, sum(b - a for a, b in inside(got, top)) / 1e3)
