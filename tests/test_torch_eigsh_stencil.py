"""The headline slice: ``bench.py``'s solve (the 7-point Laplacian
Stencil3DOperator with the shift-aware JacobiPrecond, k=10 smallest,
JDQMR_ETol, block 2, basis 24, restart 14, tol 1e-5, f32, probe on) and
``__graft_entry__.entry``'s GD_Olsen_plusK + Jacobi, at 16^3, through
``solve_eigs`` in both packages on the same operator and numpy ``v0``;
and the port's ``eigsh(..., jacobi=True)`` on the stencil.

Tolerances: eigenvalues within 1e-4 of each other and of the closed-form
spectrum (a converged pair's eigenvalue error is ~tol^2 ||A||, far below);
true residuals within 1.5 tol ||A||; matvec counts within the reference
test harness's slack of 2x (the random streams differ, so the iterations
do); probe verdicts equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from primme_tpu import operators as JO
from primme_tpu import params as jp
from primme_tpu.core.inner import jdqmr_inner_solve as j_jdqmr
from primme_tpu.core.solver import solve_eigs as j_solve
import primme_tpu_torch as ptt
from primme_tpu_torch.convert import (jacobi_from_jax, params_from_jax,
                                      stencil_from_jax)
from primme_tpu_torch.core.inner import jdqmr_inner_solve as t_jdqmr
from primme_tpu_torch.core.solver import solve_eigs as t_solve
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST
from test_torch_problems import laplacian27_permuted

M = 16
MV_SLACK = 2.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the solve is a long chain of small ops: beside parallel test
    # workers, extra intra-op threads only contend for the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stencil_eigenvalues(m, k):
    """The k smallest eigenvalues of the 7-point Dirichlet Laplacian on an
    m^3 grid, in closed form."""
    ax = 2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    return np.sort((ax[:, None, None] + ax[None, :, None]
                    + ax[None, None, :]).ravel())[:k]


def _true_residuals(m, w, X):
    op = ptt.Stencil3DOperator(m, m, m, dtype=torch.float64, device="cpu")
    Xt = torch.as_tensor(np.asarray(X, np.float64))
    R = op.matmat(Xt) - Xt * torch.as_tensor(np.asarray(w, np.float64))
    return torch.linalg.vector_norm(R, dim=0).numpy()


CASES = {
    # bench.py:45-51
    "jdqmr_etol": dict(method="JDQMR_ETol", k=10, blk=2, params=dict(
        eps=1e-5, max_basis_size=24, max_block_size=2, min_restart_size=14,
        max_matvecs=16000, locking=0)),
    # __graft_entry__.entry's method, run to convergence
    "gd_olsen_plusk": dict(method="GD_Olsen_plusK", k=4, blk=1,
                           params=dict(eps=1e-4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stencil_jacobi_solve_matches_reference(case):
    c = CASES[case]
    n, k, tol = M ** 3, c["k"], c["params"]["eps"]
    A = JO.Stencil3DOperator(M, M, M, dtype=jnp.float32)
    K = JO.JacobiPrecond(A.diagonal())
    p = jp.set_method(getattr(jp.Method, c["method"]),
                      jp.PrimmeParams(n=n, num_evals=k, **c["params"]),
                      has_precond=True)
    v0 = np.random.default_rng(0).normal(size=(n, c["blk"]))
    jinner = j_jdqmr if c["method"] == "JDQMR_ETol" else None
    rj = jax.jit(lambda v: j_solve(A, p, K=K, v0=v, dtype=jnp.float32,
                                   inner_solve=jinner))(
        jnp.asarray(v0, jnp.float32))

    At, Kt = stencil_from_jax(A, "cpu"), jacobi_from_jax(K, "cpu")
    launches = (ST.LAUNCHES, JK.LAUNCHES)
    rt = t_solve(At, params_from_jax(p), K=Kt,
                 v0=torch.as_tensor(v0, dtype=torch.float32),
                 dtype=torch.float32, device="cpu",
                 inner_solve=t_jdqmr if jinner is not None else None)
    assert (ST.LAUNCHES, JK.LAUNCHES) == launches   # the CPU: plain versions
    assert rt.evals.device == torch.device("cpu")

    ev = stencil_eigenvalues(M, k)
    wj, wt = np.asarray(rj.evals), rt.evals.numpy()
    anorm = float(rj.stats.anorm_estimate)
    assert abs(rt.stats.anorm_estimate - anorm) <= 1e-4 * anorm
    for w, X in ((wj, np.asarray(rj.evecs)), (wt, rt.evecs.numpy())):
        assert _true_residuals(M, w, X).max() <= 1.5 * tol * anorm
    assert np.abs(np.sort(wt) - ev).max() <= 1e-4
    assert np.abs(np.sort(wj) - ev).max() <= 1e-4
    assert np.abs(np.sort(wt) - np.sort(wj)).max() <= 1e-4
    mj, mt = int(rj.stats.num_matvecs), rt.stats.num_matvecs
    assert mj / MV_SLACK <= mt <= MV_SLACK * mj, (mt, mj)
    # the preconditioner ran: every correction is preconditioned
    assert rt.stats.num_preconds > 0 and int(rj.stats.num_preconds) > 0
    assert rt.stats.probe_exhausted == int(rj.stats.probe_exhausted) == 0
    assert rt.stats.probe_verified == 1
    assert rt.stats.num_probe_rounds >= 2 and rj.stats.num_probe_rounds >= 2


def test_eigsh_builds_jacobi_on_the_stencil(monkeypatch):
    built = []
    orig = ptt.api.JacobiPrecond

    def spy(d, *a, **kw):
        built.append(d)
        return orig(d, *a, **kw)

    monkeypatch.setattr(ptt.api, "JacobiPrecond", spy)
    A = ptt.Stencil3DOperator(M, M, M, device="cpu")
    w, X, st = ptt.eigsh(A, k=10, which="SA", tol=1e-5, jacobi=True,
                         method="PRIMME_JDQMR_ETol", maxBlockSize=2, ncv=24,
                         minRestartSize=14, return_stats=True, device="cpu")
    assert len(built) == 1 and torch.equal(built[0], A.diagonal())
    assert st["num_preconds"] > 0 and st["probe_verified"] == 1
    assert np.abs(np.sort(w) - stencil_eigenvalues(M, 10)).max() <= 1e-4
    assert _true_residuals(M, w, X).max() <= 1.5e-5 * st["anorm_estimate"]


def test_eigsh_takes_a_jacobi_opinv():
    # a port JacobiPrecond given as OPinv passes through to the solver
    m = 8
    A = ptt.Stencil3DOperator(m, m, m, device="cpu")
    K = ptt.JacobiPrecond(A.diagonal(), eps=1e-6)
    w, st = ptt.eigsh(A, k=3, which="SA", tol=1e-4, OPinv=K,
                      return_eigenvectors=False, return_stats=True,
                      device="cpu")
    assert st["num_preconds"] > 0
    assert np.abs(np.sort(w) - stencil_eigenvalues(m, 3)).max() <= 1e-4


def test_eigsh_jacobi_needs_a_diagonal():
    op, _ = ptt.rcm_banded(laplacian27_permuted(16)[0])
    with pytest.raises(ValueError, match="diagonal"):
        ptt.eigsh(op, k=2, which="SA", jacobi=True, device="cpu")
