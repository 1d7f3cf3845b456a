"""Orthogonality constraints (``lock=``, the reference binding's name for
them; ``solve_eigs(ortho_const=...)``): the port against the JAX package
on the same numpy inputs. Columns ``[0, noc)`` of the solver's ``evecs``
hold the constraints, and the returned vectors are orthogonal to them.

Tolerances: eigenvalues within the fixtures' own bounds of LAPACK's
(``tests/test_eigsh.py::test_deflation_constraints``: 1e-7 relative;
``tests/test_sweep.py::test_sweep_ortho_const``: 1e-6 x 40; the stencil:
1e-4 of the closed form at tol 1e-5 in f32), returned vectors orthogonal
to the constraints to 1e-8 in f64 and 1e-5 in f32, matvecs within
``mv_slack=2`` of the JAX package's (random numbers differ).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from primme_tpu import eigsh as jeigsh, Method as JMethod
import primme_tpu as pt
import primme_tpu_torch as ptt
from test_torch_problems import tridiag_fixture


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(A, lock, k, bound, expect, **kw):
    wj, _, stj = jeigsh(A, k=k, which="SA", lock=lock, return_stats=True,
                        raise_for_unconverged=False, **kw)
    kw = {a: (v.name if isinstance(v, JMethod) else v) for a, v in kw.items()}
    wt, Xt, stt = ptt.eigsh(A, k=k, which="SA", lock=lock, device="cpu",
                            return_stats=True, raise_for_unconverged=False,
                            **kw)
    for w in (np.asarray(wj), wt):
        assert np.abs(np.sort(w) - expect).max() < bound
    assert np.abs(lock.T @ Xt).max() < 1e-8
    mv_j, mv_t = int(stj["num_matvecs"]), stt["num_matvecs"]
    assert mv_j / 2 <= mv_t <= 2 * mv_j, (mv_t, mv_j)


def test_deflation_constraints():
    # tests/test_eigsh.py::test_deflation_constraints
    A, ref = tridiag_fixture()
    w, v = np.linalg.eigh(A.toarray())
    _both(A, v[:, :2], 3, 1e-7 * 100, ref[2:5], tol=1e-9)


@pytest.mark.parametrize("method,nlock", [(JMethod.GD_Olsen_plusK, 1),
                                          (JMethod.JDQMR_ETol, 3)],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_sweep_ortho_const_cases(method, nlock):
    # tests/test_sweep.py::test_sweep_ortho_const's grid (its fixture)
    import scipy.sparse as sp

    n = 80
    A = sp.diags([np.linspace(1, 40, n), 0.5 * np.ones(n - 1),
                  0.5 * np.ones(n - 1)], [0, 1, -1]).tocsr()
    ref, V = np.linalg.eigh(A.toarray())
    _both(A, V[:, :nlock], 3, 1e-6 * 40, ref[nlock:nlock + 3], tol=1e-8,
          method=method, maxMatvecs=9000)


def test_lock_validation():
    A, _ = tridiag_fixture()
    with pytest.raises(ValueError, match="lock= must be an"):
        ptt.eigsh(A, k=2, which="SA", lock=np.ones((7, 2)), device="cpu")


def test_stencil_constraints_solve_eigs():
    """``chip_smoke.py`` phase 17 at 10^3 through both packages'
    ``solve_eigs(ortho_const=...)``: the closed-form eigenvectors of
    lambda_1-4 as constraints, the next six in f32 with Jacobi."""
    import chip_smoke as CS
    from primme_tpu.core.inner import jdqmr_inner_solve as jinner
    from primme_tpu.core.solver import solve_eigs as jsolve
    from primme_tpu_torch.core.inner import jdqmr_inner_solve as tinner
    from primme_tpu_torch.core.solver import solve_eigs as tsolve

    m, k = 10, CS.LOCK_K
    L = CS.stencil_modes(m, CS.LOCK_MODES)
    lam, _ = CS.stencil_eigenvalues(m, len(CS.LOCK_MODES) + k)
    n = m ** 3
    p = pt.set_method(pt.Method.JDQMR_ETol, pt.PrimmeParams(
        n=n, num_evals=k, eps=1e-5, max_basis_size=24, max_block_size=2,
        min_restart_size=14, num_ortho_const=L.shape[1]), has_precond=True)
    p = pt.resolve_defaults(p)
    Aj = pt.Stencil3DOperator(m, m, m, dtype=jnp.float32)
    rj = jsolve(Aj, p, K=pt.JacobiPrecond(Aj.diagonal()),
                ortho_const=jnp.asarray(L, jnp.float32),
                inner_solve=jinner, dtype=jnp.float32)
    from primme_tpu_torch.convert import params_from_jax

    At = ptt.Stencil3DOperator(m, m, m, dtype=torch.float32, device="cpu")
    rt = tsolve(At, params_from_jax(p), K=ptt.JacobiPrecond(At.diagonal()),
                ortho_const=torch.as_tensor(L, dtype=torch.float32),
                inner_solve=tinner, dtype=torch.float32)
    for ev in (np.asarray(rj.evals), rt.evals.numpy()):
        assert np.abs(np.sort(ev) - lam[len(CS.LOCK_MODES):]).max() <= 1e-4
    assert np.abs(L.T @ rt.evecs.numpy().astype(np.float64)).max() <= 1e-5
    mv_j, mv_t = int(rj.stats.num_matvecs), rt.stats.num_matvecs
    assert mv_j / 2 <= mv_t <= 2 * mv_j, (mv_t, mv_j)
    assert rt.stats.probe_verified == 1
