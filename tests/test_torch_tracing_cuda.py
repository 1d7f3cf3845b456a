"""The count of host reads misses no synchronisation, on the card.

For a small ``eigsh`` (the north star's f32 stage at 16^3: JDQMR_ETol,
the Jacobi preconditioner, the spectrum probe, a start block from the
host) and a ``refine_eigsh`` of its vectors (f64, Chebyshev(8)), the
synchronisations that ``torch.cuda.set_sync_debug_mode("warn")`` reports
during the call number exactly ``stats["num_host_reads"]``: every
implicit read (``int``, ``float``, ``bool`` of a device tensor), every
blocking copy to the card and every ``torch.linalg`` call that checks its
result on the host goes through ``core.linalg.host_read``, and each of
them waits once. The operators are built before the call. This file
imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing_cuda.py

Every test here needs a card and skips without one."""

import warnings

import numpy as np
import pytest
import torch

import primme_tpu_torch as ptt


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
def test_host_reads_count_every_synchronisation(card):
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
