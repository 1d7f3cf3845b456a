"""The traced run: spans of the benchmark's own around the program's
calls and kernel entries, and the profiler's events reduced to tuples.

Only a run with ``--trace 1`` opens any of this. The spans are
``torch.profiler.record_function`` ranges named ``bench.<what>``; the
kernel entries are wrapped by replacing the module attribute the
program's operators call (``primme_tpu_torch.ops.stencil3d.matmat``,
``primme_tpu_torch.ops.jacobi.shifted`` and ``.unshifted``) for the
duration of the traced window, and the stencil's wrapper records the
shape of every call it passes on.
"""

from __future__ import annotations

import contextlib
import importlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def span(name: str, on: bool):
    """A ``bench.<name>`` range while a traced run records; else nothing."""
    return record_function("bench." + name) if on else \
        contextlib.nullcontext()


@contextlib.contextmanager
def kernel_entries(program: str):
    """Wrap the stencil and Jacobi kernel entries of ``program`` (the
    package's name) in spans; yields the list that receives ``(entry, n,
    k, itemsize)`` for every stencil call."""
    ST = importlib.import_module(program + ".ops.stencil3d")
    JK = importlib.import_module(program + ".ops.jacobi")
    calls: list = []
    orig = (ST.matmat, JK.shifted, JK.unshifted)

    def stencil(X, nx, ny, nz, scale=1.0):
        entry = "stencil3d_" + str(X.dtype).replace("torch.", "")
        calls.append((entry, X.shape[0], X.shape[1], X.element_size()))
        with record_function("bench." + entry):
            return orig[0](X, nx, ny, nz, scale)

    def shifted(X, d, sigma, eps):
        with record_function("bench.jacobi_shifted"):
            return orig[1](X, d, sigma, eps)

    def unshifted(X, d, eps):
        with record_function("bench.jacobi"):
            return orig[2](X, d, eps)

    ST.matmat, JK.shifted, JK.unshifted = stencil, shifted, unshifted
    try:
        yield calls
    finally:
        ST.matmat, JK.shifted, JK.unshifted = orig


def recorder():
    """A profiler of the host and the card, recording from ``__enter__``."""
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def digest(prof) -> dict:
    """The profiler's events as tuples ``(name, start_us, end_us)``:
    ``device`` (kernels, copies and sets: the events on the card's track
    that are not scope ranges), ``device_scopes`` (scope ranges on the
    card's track), ``host_spans`` (scopes as the host entered them);
    ``kinds`` counts the events by track and kind. Reads the profiler's
    raw results, which skips building its per-event Python objects."""
    out = {"device": [], "device_scopes": [], "host_spans": [], "kinds": {}}
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        on_host = e.device_type() == cpu
        scope = e.is_user_annotation()
        key = ("host " if on_host else "device ") + \
            ("scope" if scope else "event")
        out["kinds"][key] = out["kinds"].get(key, 0) + 1
        if on_host and not scope:
            continue
        t = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if scope:
            (out["host_spans"] if on_host else out["device_scopes"]).append(t)
        else:
            out["device"].append(t)
    return out
