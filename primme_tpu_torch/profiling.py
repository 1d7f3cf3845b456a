"""Profiling: the solver's phases on the card's clock.

PyTorch port of ``primme_tpu/profiling.py``. The reference's C library
compiles a regex-gated wall-clock tracer into every call frame and
reports matches through the monitor; the JAX package traces the solve
with the XLA profiler and attributes device time to named scopes. The
port does the same with ``torch.profiler``: the solver's operator
applications run under ``pt_matvec``, the preconditioner's under
``pt_precond``, the block orthogonalization under ``pt_ortho`` and the
projected solves, residuals and restarts under ``pt_dense``
(:func:`~primme_tpu_torch.core.linalg.scope`).

    with primme_tpu_torch.profiling.trace("/tmp/primme_trace"):
        eigsh(A, k=10, ...)
    # then open the Chrome trace file written there

Per-solve counters are always available through ``return_stats``, the
outer-iteration event stream through ``monitor=``/``return_history``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_SCOPES = ("pt_matvec", "pt_precond", "pt_ortho", "pt_dense")


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed solves with ``torch.profiler`` (CPU and, where
    there is a card, CUDA activities) and write a Chrome trace file into
    ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _union_us(spans):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _innermost(spans, dev):
    """For each device event of ``dev`` (sorted by start), the name of the
    innermost of the nested ``(start, end, name)`` spans that contains
    it, or None."""
    out, stack, i = [], [], 0
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        while i < len(spans) and spans[i][0] <= a:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < b:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def breakdown_from_events(events) -> dict:
    """Device time by phase from a ``torch.profiler`` event list.

    The profiler records, on the device's track, a span for each run of a
    phase scope that holds every kernel launched inside it (by torch's
    operations and by an extension's own launches alike). Each device
    event (kernel, copy, set) goes to the innermost span holding it, so a
    kernel of ``pt_precond`` inside ``pt_matvec`` counts once, for
    ``pt_precond``; device time in no span is ``other``, the total less
    the scopes'. Returns ``{}`` when the list holds no device event.
    ``busy_us`` is the union of the device events' intervals, which the
    total equals when no two overlap and none was counted twice;
    ``kernels_us`` the device time by kernel name."""
    from torch.autograd import DeviceType

    dev, ann = [], []
    for e in events:
        if e.device_type == DeviceType.CPU:
            continue
        if e.name in _SCOPES:
            ann.append((e.time_range.start, e.time_range.end, e.name))
        elif not getattr(e, "is_user_annotation", False):
            dev.append(e)
    if not dev:
        return {}
    dev.sort(key=lambda e: e.time_range.start)
    ann.sort(key=lambda t: (t[0], -t[1]))
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    buckets = {k: 0.0 for k in _SCOPES}
    by_name: dict = {}
    for e, name in zip(dev, _innermost(ann, dev)):
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if name is not None:
            buckets[name] += us
    total = sum(b - a for a, b in spans)
    return {"buckets_us": buckets,
            "other_us": total - sum(buckets.values()), "total_us": total,
            "busy_us": _union_us(spans), "kernels_us": by_name}


def measure_breakdown(fn, *args, device) -> dict:
    """MEASURED in-solve time breakdown (``primme_stats``
    ``timeMatvec/timePrecond/timeOrtho/timeDense``).

    Runs ``fn(*args)`` once untimed (the kernels' builds and the
    libraries' handles), then once under ``torch.profiler`` with the CPU
    and CUDA activities, and attributes each device event's time to the
    innermost phase scope it ran in (:func:`breakdown_from_events`).
    Device time outside the four scopes is ``time_other``;
    ``device_idle`` is the traced wall clock less the device's busy time
    (the card waiting on the host); ``device_kernels`` the device time by
    kernel name. ``device`` is the device the solve runs on. Returns
    ``{}`` at once when it is not a card, and when the trace holds no
    device event: callers fall back to :func:`time_breakdown`. Not for a
    timed path: the profiler's post-processing grows with the event count
    (a 64^3 trace takes minutes)."""
    if torch.device(device).type != "cuda" or \
            torch.profiler.ProfilerActivity.CUDA \
            not in torch.profiler.supported_activities():
        return {}
    fn(*args)
    _sync(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    br = breakdown_from_events(prof.events())
    post = time.perf_counter() - t1
    if not br:
        return {}
    sec = 1e-6
    b = br["buckets_us"]
    return {
        "time_matvec": b["pt_matvec"] * sec,
        "time_precond": b["pt_precond"] * sec,
        "time_ortho": b["pt_ortho"] * sec,
        "time_dense": b["pt_dense"] * sec,
        "time_other": br["other_us"] * sec,
        "device_busy": br["busy_us"] * sec,
        "device_kernels": {k: v * sec for k, v in sorted(
            br["kernels_us"].items(), key=lambda kv: -kv[1])},
        "device_idle": max(wall - br["busy_us"] * sec, 0.0),
        "time_global_sum": 0.0,
        "time_broadcast": 0.0,
        "profiled_wall": wall,
        "profile_post_seconds": post,
        "time_source": "measured",
    }


def _time_op(device, fn, *args, reps: int = 3) -> float:
    """Median host time of ``fn(*args)`` after one warm-up call, each
    call ending in a synchronisation of ``device``."""
    fn(*args)
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def time_breakdown(A, K, stats: dict, *, mmax: int, blk: int, cwin: int,
                   dtype, n: int = None) -> dict:
    """ESTIMATED per-phase breakdown (``primme_stats``
    ``timeMatvec/timePrecond/timeOrtho/timeDense``), the reference's
    fallback where no device trace exists: each phase's representative
    operation is timed alone at the solve's shapes and multiplied by the
    solve's own counters.

    * ``time_matvec``  — ``num_matvecs`` operator columns
    * ``time_precond`` — ``num_preconds`` preconditioner columns
    * ``time_ortho``   — one ``block_ortho`` an outer iteration, plus one
    * ``time_dense``   — one residual pass a window
    * ``time_other``   — what ``elapsed_time`` leaves

    Returns a new dict: ``stats`` with the ``time_*`` keys added."""
    from .core.linalg import block_ortho, compute_residuals, real_dtype
    from .operators import apply_precond

    n = n if n is not None else A.shape[0]
    dev = A.device
    dtype = dtype if isinstance(dtype, torch.dtype) else A.dtype
    gen = torch.Generator().manual_seed(0)
    X = torch.randn((n, blk), generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        X = X + 1j * torch.randn((n, blk), generator=gen,
                                 dtype=torch.float64)
    X = X.to(device=dev, dtype=dtype)
    V = torch.zeros((n, mmax), dtype=dtype, device=dev)
    V[:, :blk] = X
    hv = torch.zeros((mmax, cwin), dtype=dtype, device=dev)
    hv[:blk, :] = 1.0
    hl = torch.ones((cwin,), dtype=real_dtype(dtype), device=dev)

    t_mv = _time_op(dev, A.matmat, X) / blk
    t_prec = 0.0
    if K is not None:
        sig = torch.zeros((blk,), dtype=real_dtype(dtype), device=dev)
        t_prec = _time_op(dev, lambda D: apply_precond(K, D, sig), X) / blk
    t_ortho = _time_op(dev, lambda x: block_ortho(
        x, V, None, blk, torch.Generator().manual_seed(1)).X, X)
    t_dense = _time_op(dev, lambda v: compute_residuals(v, v, None, hv,
                                                   hl).resnorms, V)

    out = dict(stats)
    nwin = stats["num_outer_iterations"] + stats["num_restarts"] + 1
    out["time_matvec"] = t_mv * stats["num_matvecs"]
    out["time_precond"] = t_prec * stats["num_preconds"]
    out["time_ortho"] = t_ortho * (stats["num_outer_iterations"] + 1)
    out["time_dense"] = t_dense * nwin
    out["time_global_sum"] = 0.0
    out["time_broadcast"] = 0.0
    out["time_other"] = max(0.0, stats.get("elapsed_time", 0.0)
                            - out["time_matvec"] - out["time_precond"]
                            - out["time_ortho"] - out["time_dense"])
    return out
