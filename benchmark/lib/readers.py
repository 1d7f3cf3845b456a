"""What the per-layer metrics read from a traced run, shared by the
metric files of ``benchmark/metrics/`` (a quantity read in cells that
report different end-to-end metrics has one file for each, since a
metric ``moves`` one end-to-end metric, and the same reader).

A run is a dict: ``calls`` (each call's counters), ``times``,
``window_s``, ``peak_bytes`` and ``setup_s`` (what the end-to-end
metrics read) and, in a traced run, ``trace`` (the profiler's events as
tuples, :func:`lib.profile.digest`), ``stencil_calls`` (``(entry, n, k,
itemsize)`` of every stencil call the harness's wrapper passed on) and
``window_us`` (the traced calls' span); ``kind`` is the card's name.
Each reader returns None where it finds nothing to read.
"""

from __future__ import annotations

import sys

from . import cost
from . import trace as T


def mean_counter(run, key: str):
    """The mean over the traced calls of a counter they report."""
    got = [c[key] for c in run["calls"] if key in c]
    return sum(got) / len(got) if got else None


def scope_ms(run, scope: str):
    """Device milliseconds a call under a program scope: the kernels whose
    innermost scope on the card's track is ``scope``."""
    tr = run["trace"]
    if not run["calls"] or not any(s[0] == scope
                                   for s in tr["device_scopes"]):
        return None
    return T.scope_us(tr["device"], tr["device_scopes"], scope) / 1e3 \
        / len(run["calls"])


def idle_share(run):
    """Percent of the traced window with no kernel, copy or set."""
    lo, hi = run["window_us"]
    if lo is None or hi <= lo or not run["trace"]["device"]:
        return None
    return 100.0 * (1.0 - T.busy_us(run["trace"]["device"], lo, hi)
                    / (hi - lo))


def stencil_f64_roofline(run):
    """The f64 stencil's share of its roofline in percent: the least time
    of the traced launches over the device time of the kernels named
    ``stencil3d_kernel<double, ...>``."""
    launches = [(n, k, size) for entry, n, k, size in run["stencil_calls"]
                if entry == "stencil3d_float64"]
    kern = [e for e in run["trace"]["device"]
            if "stencil3d" in e[0] and "double" in e[0]]
    secs = sum(b - a for _, a, b in kern) * 1e-6
    got = cost.stencil7_roofline(launches, secs, cost.PEAKS.get(run["kind"]),
                                 "float64")
    if got is None:
        return None
    share, bound = got
    print(f"[stencil3d_f64 roofline] {share:.4f} % of the {bound} bound: "
          f"{len(launches)} calls, {len(kern)} kernels, {secs:.6f} s",
          file=sys.stderr, flush=True)
    return share
