"""The count of host reads misses no synchronisation, on the card.

For a small ``eigsh`` (the north star's f32 stage at 16^3: JDQMR_ETol,
the Jacobi preconditioner, the spectrum probe, a start block from the
host) and a ``refine_eigsh`` of its vectors (f64, Chebyshev(8)), the
synchronisations that ``torch.cuda.set_sync_debug_mode("warn")`` reports
during the call number exactly ``stats["num_host_reads"]``: every
implicit read (``int``, ``float``, ``bool`` of a device tensor), every
blocking copy to the card and every ``torch.linalg`` call that checks its
result on the host goes through ``core.linalg.host_read``, and each of
them waits once; so does each chunk of rows of the polish's results on
their way to the host, at one chunk and at five. The operators are built
before the call. This file
imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing_cuda.py

Every test here needs a card and skips without one."""

import warnings

import numpy as np
import pytest
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch import refine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _syncs(fn):
    """``(result, syncs)``: ``fn()`` and the synchronisations the card's
    debug mode reported while it ran (the mode is set before the count
    starts: the first setting in a process can report one of its own)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


@pytest.mark.cuda
def test_host_reads_count_every_synchronisation(card, monkeypatch):
    nx = 16
    A32 = ptt.Stencil3DOperator(nx, nx, nx, dtype=torch.float32, device=card)
    A64 = ptt.Stencil3DOperator(nx, nx, nx, dtype=torch.float64, device=card)
    K32 = ptt.JacobiPrecond(A32.diagonal())
    K64 = ptt.ChebyshevPrecond.from_operator(A64, degree=8)
    v0 = np.random.default_rng(0).standard_normal((nx ** 3, 2)).astype(
        np.float32)

    def f32():
        return ptt.eigsh(A32, k=4, which="SA", v0=v0, tol=1e-5, OPinv=K32,
                         method="JDQMR_ETol", ncv=24, maxBlockSize=2,
                         minRestartSize=8, locking=False, return_stats=True,
                         device=card)

    def f64(X):
        return ptt.refine_eigsh(A64, X, tol=1e-10, OPinv=K64, maxiter=200,
                                return_stats=True, device=card)

    _, X, _ = f32()                 # the kernels' builds and handles
    f64(X)
    (_, X, st), n = _syncs(f32)
    assert st["num_probe_rounds"] > 0 and st["num_restarts"] > 0
    assert n == st["num_host_reads"] > 0
    (_, _, rst), n = _syncs(lambda: f64(X))
    assert n == rst["num_host_reads"] > 0
    assert rst["to_host_chunks"] == 1
    # 1000 rows a chunk: the 4096 rows of the results cross in five
    monkeypatch.setattr(refine, "_CHUNK_BYTES", 8 * 4 * 1000)
    (_, _, rst5), n = _syncs(lambda: f64(X))
    assert rst5["to_host_chunks"] == 5 and n == rst5["num_host_reads"]
    # two reads a step; the copy's four more chunks, four more reads
    assert (rst5["num_host_reads"] - 2 * rst5["num_refine_iters"]
            == rst["num_host_reads"] - 2 * rst["num_refine_iters"] + 4)


@pytest.mark.cuda
def test_each_chunk_waits_in_a_read_under_pt_to_host(card, monkeypatch):
    """The results' copy stays under ``pt_to_host``: the values' read, the
    order's copy to the card, one read a chunk of rows and the residuals'
    read, each a ``pt_read`` inside it."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(refine, "_CHUNK_BYTES", 8 * 4 * 1000)
    nx = 16
    A64 = ptt.Stencil3DOperator(nx, nx, nx, dtype=torch.float64, device=card)
    X0 = np.random.default_rng(0).standard_normal((nx ** 3, 4))
    ptt.refine_eigsh(A64, X0, tol=1e-10, maxiter=5, device=card)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, st = ptt.refine_eigsh(A64, X0, tol=1e-10, maxiter=5,
                                    return_stats=True, device=card)
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    (top,) = [s for s in spans if s[0] == "pt_to_host"]
    reads = [s for s in spans if s[0] == "pt_read"]
    inside = [s for s in reads if top[1] <= s[1] and s[2] <= top[2]]
    assert st["to_host_chunks"] == 5
    assert len(inside) == 3 + 5
    assert len(reads) == st["num_host_reads"]
