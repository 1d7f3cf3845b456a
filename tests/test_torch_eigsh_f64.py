"""The double-precision slice: the port's sparse ``eigsh`` on an f64 matrix
(format chooser -> f64 windowed-slot ELL -> block JDQMR_ETol with the
verification probe) against the JAX package's on the same matrix, settings
and ``v0``; and an f64 solve over an f32 operator (``dtype=np.float64``,
the ``CastOperator`` boundary) in both packages.

The problem is the 27-point Laplacian on a 16^3 grid in random node order
(n = 4096, so the chooser takes the windowed format), k=10 smallest; its
spectrum is known in closed form. In f64 each package runs its own f64
windowed operator: the JAX one through ``matmat_ds``'s CPU path (a plain
f64 gather), the port's through its plain product on the CPU. For the
cast the JAX reference runs an f32 ``ELLOperator`` of the RCM-reordered
matrix (its f32 windowed product is interpreted Pallas on the CPU, seconds
per call); the port its f32 windowed operator.

Tolerances: at tol=1e-10 eigenvalues within 1e-9 of each other and of the
closed form (a converged pair's eigenvalue error is about tol^2 ||A||,
far below; 1e-9 leaves room for f64 rounding over ||A|| ~ 36); at tol=1e-6
within 10 tol, as the f32 slice's test holds tol=1e-5 to 1e-4. True
residuals within 1.5 tol ||A||; matvec counts within the reference test
harness's slack of 2x (random streams differ, so the iterations do);
probe verdicts equal."""

import numpy as np
import pytest
import torch

import primme_tpu
from primme_tpu.operators import ELLOperator
import primme_tpu_torch
from primme_tpu_torch.ops import windowed_ell as WE
from test_torch_problems import laplacian27_permuted

MV_SLACK = 2.0
KW = dict(k=10, which="SA", method="PRIMME_JDQMR_ETol", maxBlockSize=2,
          ncv=24, minRestartSize=14, return_stats=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the solve is a long chain of small ops: beside parallel test
    # workers, extra intra-op threads only contend for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_pair(Ap, ev, tol, ev_tol, port, ref):
    (wt, Xt, st), (wj, Xj, sj) = port, ref
    anorm = float(np.abs(ev).max())
    A64 = Ap.astype(np.float64)
    for w, X in ((wt, Xt), (wj, Xj)):
        assert w.dtype == np.float64 and X.dtype == np.float64
        res = np.linalg.norm(A64 @ X - X * w, axis=0)
        assert res.max() <= 1.5 * tol * anorm, res.max()
    wt, wj = np.sort(wt), np.sort(wj)
    assert np.abs(wt - ev[:10]).max() <= ev_tol
    assert np.abs(wj - ev[:10]).max() <= ev_tol
    assert np.abs(wt - wj).max() <= ev_tol
    assert sj["num_matvecs"] / MV_SLACK <= st["num_matvecs"] \
        <= MV_SLACK * sj["num_matvecs"]
    assert (st["probe_exhausted"], st["probe_verified"]) == (
        sj["probe_exhausted"], 1)


def test_eigsh_f64_slice_matches_reference():
    Ap, ev = laplacian27_permuted(16)
    Ap = Ap.astype(np.float64)        # entries 26 and -1: exact
    n = Ap.shape[0]
    tol = 1e-10
    v0 = np.random.default_rng(1).standard_normal((n, 14))

    op, _ = primme_tpu_torch.rcm_banded(Ap)
    assert isinstance(op, primme_tpu_torch.WindowedELLOperator)
    assert op.dtype == torch.float64
    launches = dict(WE.KERNEL_LAUNCHES)
    port = primme_tpu_torch.eigsh(Ap, v0=v0, tol=tol, device="cpu", **KW)
    assert WE.KERNEL_LAUNCHES == launches    # the CPU runs the plain product

    from primme_tpu.operators import rcm_banded as jrcm, WindowedELLOperator
    jop, _ = jrcm(Ap)
    assert isinstance(jop, WindowedELLOperator) and jop.vals_lo is not None
    wj, Xj, sj = primme_tpu.eigsh(Ap, v0=v0, tol=tol, **KW)
    _check_pair(Ap, ev, tol, 1e-9, port,
                (np.asarray(wj), np.asarray(Xj), sj))


def test_eigsh_f64_over_f32_operator_matches_reference():
    Ap, ev = laplacian27_permuted(16)
    n = Ap.shape[0]
    tol = 1e-6
    v0 = np.random.default_rng(1).standard_normal((n, 14))

    op, perm = primme_tpu_torch.rcm_banded(Ap)
    assert op.dtype == torch.float32
    port = primme_tpu_torch.eigsh(Ap, v0=v0, tol=tol, dtype=np.float64,
                                  device="cpu", **KW)

    Ar = Ap[perm][:, perm]
    wj, Xj, sj = primme_tpu.eigsh(ELLOperator.from_scipy(Ar), v0=v0[perm],
                                  tol=tol, dtype=np.float64, **KW)
    Xj = np.asarray(Xj)[np.argsort(perm)]
    _check_pair(Ap, ev, tol, 10 * tol, port, (np.asarray(wj), Xj, sj))
