"""Arithmetic on a device trace, on plain tuples.

An event or a span is ``(name, start_us, end_us)``. Device events are the
kernels, copies and sets the card ran; device annotations are the spans a
profiler scope covers on the card's track; host spans are the scopes as
the host entered them. Nothing here needs a card or a profiler, so the
arithmetic is tested on synthetic events. The union of intervals and the
innermost-scope rule follow ``primme_tpu_torch/profiling.py``
(``_union_us``, ``_innermost``, ``breakdown_from_events``), copied so that
the benchmark's yardstick does not move with the program.
"""

from __future__ import annotations


def merged(spans):
    """The union of ``(start, end)`` intervals as disjoint, sorted ones."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_us(spans) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in merged(spans))


def clip(spans, lo: float, hi: float):
    """The parts of ``(start, end)`` intervals inside ``[lo, hi]``."""
    return [(max(a, lo), min(b, hi)) for a, b in spans
            if min(b, hi) > max(a, lo)]


def innermost(annotations, points):
    """For each ``(start, end)`` of ``points`` (sorted by start), the name
    of the innermost of the nested ``(name, start, end)`` annotations that
    contains it, or None."""
    ann = sorted(annotations, key=lambda t: (t[1], -t[2]))
    out, stack, i = [], [], 0
    for a, b in points:
        while i < len(ann) and ann[i][1] <= a:
            while stack and stack[-1][2] < ann[i][1]:
                stack.pop()
            stack.append(ann[i])
            i += 1
        while stack and stack[-1][2] < b:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def scope_us(events, annotations, scope: str) -> float:
    """Device time of the events whose innermost annotation is ``scope``
    (a kernel of a scope nested in ``scope`` counts for the inner one)."""
    ev = sorted(events, key=lambda e: e[1])
    names = innermost(annotations, [(e[1], e[2]) for e in ev])
    return sum(e[2] - e[1] for e, n in zip(ev, names) if n == scope)


def busy_us(events, lo: float, hi: float) -> float:
    """Time in ``[lo, hi]`` in which at least one device event ran."""
    return union_us(clip([(e[1], e[2]) for e in events], lo, hi))


def device_ops(events, top: int = 10):
    """``[[name, seconds], ...]``: device time summed by name, the
    largest ``top``."""
    tot: dict = {}
    for name, a, b in events:
        tot[name] = tot.get(name, 0.0) + (b - a)
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name, us * 1e-6] for name, us in ranked]


def gaps(events, lo: float, hi: float):
    """The intervals of ``[lo, hi]`` in which no device event ran."""
    out, cur = [], lo
    for a, b in merged(clip([(e[1], e[2]) for e in events], lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_by_host_span(events, host_spans, lo: float, hi: float,
                      top: int = 10):
    """``[[host span, seconds], ...]``: the device's idle time in
    ``[lo, hi]``, each gap given to the innermost host span that holds its
    midpoint (``"(no span)"`` where none does), summed by span, the
    largest ``top``."""
    g = gaps(events, lo, hi)
    mids = [((a + b) / 2, (a + b) / 2) for a, b in g]
    tot: dict = {}
    for (a, b), name in zip(g, innermost(host_spans, mids)):
        key = name or "(no span)"
        tot[key] = tot.get(key, 0.0) + (b - a)
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name, us * 1e-6] for name, us in ranked]
