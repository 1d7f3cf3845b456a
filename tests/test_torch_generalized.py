"""Generalized problems A x = lambda B x: the port's B inner product
(``block_ortho(Bop=...)``, ``prefix_project2``, the QMR inner solve with
B) against the JAX package's on the same numpy inputs, and the solves
(``tests/test_eigsh.py::test_generalized``'s pencil, a Q1 finite-element
pencil and a few cases of ``tests/test_sweep.py``'s generalized grid)
through both packages' ``eigsh``.

Tolerances: the orthonormalizations and projections in f64 agree to 1e-12
relative (the same algorithm, sums in another order; no column is
replaced by a random one, so no random numbers enter); the inner solve
runs the same recurrences, so its counts are equal and its correction
agrees to 1e-9. Solves: eigenvalues within the fixture's own bound of
LAPACK's (1e-7 relative as ``test_generalized``, 1e-6 x 40 as the sweep),
``X^T B X = I`` to 1e-8, matvecs within ``mv_slack=2`` of the JAX
package's (random numbers differ, so parity is never bitwise).
"""

import types

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from primme_tpu import eigsh as jeigsh, Method as JMethod
from primme_tpu import params as jp
from primme_tpu.core import inner as ji
from primme_tpu.core import linalg as jl
from primme_tpu.core import solver as js
from primme_tpu.operators import DenseOperator
import primme_tpu_torch as ptt
from primme_tpu_torch.convert import params_from_jax
from primme_tpu_torch.core import inner as ti
from primme_tpu_torch.core import linalg as tl
from primme_tpu_torch.core import solver as ts

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1.0)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


class _Dense(ptt.LinearOperator):
    def __init__(self, A):
        super().__init__()
        self.register_buffer("A", torch.as_tensor(A))
        self.shape = tuple(A.shape)
        self.dtype = self.A.dtype

    def matmat(self, X):
        return self.A @ X


def _spd(rng, n, lo=0.5, hi=3.0):
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return (Q * np.linspace(lo, hi, n)) @ Q.T


def _b_orthonormal(rng, B, n, m, b):
    """[n, m] with its first b columns B-orthonormal, the rest zero."""
    V = np.zeros((n, m))
    X = rng.standard_normal((n, b))
    L = np.linalg.cholesky(X.T @ B @ X)
    V[:, :b] = X @ np.linalg.inv(L).T
    return V


def test_prefix_project2():
    rng = np.random.default_rng(0)
    n = 150
    B = _spd(rng, n)
    Q = _b_orthonormal(rng, B, n, 8, 3)
    BQ = B @ Q
    X = rng.standard_normal((n, 4))
    BX = B @ X
    j = jl.prefix_project2(*(jnp.asarray(a) for a in (Q, BQ, X, BX)),
                           jnp.int32(3), same=False)
    t = tl.prefix_project2(*(torch.as_tensor(a) for a in (Q, BQ, X, BX)),
                           3, same=False)
    _close(j[0], t[0])
    _close(j[1], t[1])
    # the projected block is B-orthogonal to the prefix
    _close(Q.T @ t[1].numpy(), np.zeros((8, 4)))
    j1, _ = jl.prefix_project2(jnp.asarray(Q), jnp.asarray(Q),
                               jnp.asarray(X), jnp.asarray(X), jnp.int32(3),
                               same=True)
    t1, tb1 = tl.prefix_project2(*(torch.as_tensor(a) for a in (Q, Q, X, X)),
                                 3, same=True)
    _close(j1, t1)
    assert tb1 is t1


@pytest.mark.parametrize("locked", [False, True])
def test_block_ortho_with_mass_matrix(locked):
    rng = np.random.default_rng(1)
    n, m, b, bs = 200, 10, 6, 3
    B = _spd(rng, n)
    V = _b_orthonormal(rng, B, n, m, b)
    Q = BQ = None
    if locked:
        Q = np.zeros((n, 5))
        Y = rng.standard_normal((n, 2))
        Y -= V @ (V.T @ (B @ Y))
        Q[:, :2] = Y @ np.linalg.inv(np.linalg.cholesky(Y.T @ B @ Y)).T
        BQ = B @ Q
    X = rng.standard_normal((n, bs))
    J = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    T = lambda a: None if a is None else torch.as_tensor(a)   # noqa: E731
    rj = jl.block_ortho(J(X), (J(V), J(B @ V)),
                        (J(Q), J(BQ)) if locked else None, jnp.int32(bs),
                        jax.random.PRNGKey(0), Bop=DenseOperator(J(B)),
                        locked_count=jnp.int32(2) if locked else None)
    rt = tl.block_ortho(T(X), T(V), T(Q), bs,
                        torch.Generator().manual_seed(0),
                        locked_count=2 if locked else None, Bop=_Dense(B),
                        BV=T(B @ V), BQ=T(BQ))
    assert int(rj.n_random) == rt.n_random == 0
    _close(rj.X, rt.X, 1e-10)
    _close(rj.BX, rt.BX, 1e-10)
    Xt, BXt = rt.X.numpy(), rt.BX.numpy()
    _close(BXt, B @ Xt, 1e-10)
    _close(Xt.T @ BXt, np.eye(bs), 1e-10)
    _close(V.T @ BXt, np.zeros((m, bs)), 1e-10)
    if locked:
        _close(Q.T @ BXt, np.zeros((5, bs)), 1e-10)


def test_jdqmr_inner_solve_with_mass_matrix():
    rng = np.random.default_rng(2)
    n, blk, m = 300, 2, 10
    A = _spd(rng, n, 0.1, 40.0)
    B = _spd(rng, n, 0.8, 1.6)
    V = _b_orthonormal(rng, B, n, m, m)
    w, Z = np.linalg.eigh(V.T @ A @ V)
    X = V @ Z[:, :blk]
    BX = B @ X
    lam = w[:blk]
    R = A @ X - BX * lam
    res = np.linalg.norm(R, axis=0)
    p = jp.set_method(jp.Method.JDQMR_ETol,
                      jp.PrimmeParams(n=n, num_evals=4, max_block_size=blk,
                                      eps=1e-8), has_mass=True)
    cfg_j, cfg_t = js.make_config(p), ts.make_config(params_from_jax(p))
    z = np.zeros((n, cfg_j.lockmax))
    stats = dict(num_outer_iterations=3, anorm_estimate=40.0,
                 num_matvecs=50)
    f = lambda a: jnp.asarray(a, jnp.float64)   # noqa: E731
    sj = types.SimpleNamespace(
        num_locked=jnp.int32(0), evecs=f(z), Bevecs=f(z),
        stats=types.SimpleNamespace(**{k: jnp.asarray(v)
                                       for k, v in stats.items()}))
    out_j = ji.jdqmr_inner_solve(
        cfg_j, DenseOperator(f(A)), DenseOperator(f(B)), None, sj, f(X),
        f(BX), f(R), f(lam), f(res), jnp.ones((blk,), bool), f(4e-7),
        evals=f(lam))
    t = torch.as_tensor
    st = types.SimpleNamespace(num_locked=0, evecs=t(z), Bevecs=t(z),
                               stats=types.SimpleNamespace(**stats))
    out_t = ti.jdqmr_inner_solve(
        cfg_t, _Dense(A), _Dense(B), None, st, t(X), t(BX), t(R), t(lam),
        t(res), torch.ones((blk,), dtype=torch.bool), 4e-7, evals=t(lam))
    sol_j, its_j, nmv_j, nprec_j = (np.asarray(x) for x in out_j)
    sol_t, its_t, nmv_t, nprec_t, trace_t = out_t
    assert trace_t is None      # no inner_trace_cap, no step buffer
    assert (int(its_j), int(nmv_j), int(nprec_j)) == (its_t, nmv_t, nprec_t)
    assert its_t > 1
    assert np.abs(sol_t.numpy() - sol_j).max() <= 1e-9 * np.abs(sol_j).max()


def _pencil_solves(A, B, ref, k, which, bound, **kw):
    wj, Xj, stj = jeigsh(A, k=k, M=B, which=which, return_stats=True,
                         raise_for_unconverged=False, **kw)
    kw = {a: (v.name if isinstance(v, JMethod) else v) for a, v in kw.items()}
    wt, Xt, stt = ptt.eigsh(A, k=k, M=B, which=which, return_stats=True,
                            raise_for_unconverged=False, device="cpu", **kw)
    expect = ref[:k] if which == "SA" else ref[-k:]
    for w in (np.asarray(wj), wt):
        assert np.abs(np.sort(w) - np.sort(expect)).max() < bound
    Bd = B.toarray() if sp.issparse(B) else B
    assert np.abs(Xt.T @ Bd @ Xt - np.eye(k)).max() < 1e-8
    mv_j, mv_t = int(stj["num_matvecs"]), stt["num_matvecs"]
    assert mv_j / 2 <= mv_t <= 2 * mv_j, (mv_t, mv_j)
    return wt, Xt


def test_generalized():
    # tests/test_eigsh.py::test_generalized
    rng = np.random.default_rng(4)
    n = 120
    B = sp.diags(1.0 + rng.random(n)).tocsr()
    A = sp.diags([np.linspace(1, 60, n), 0.2 * np.ones(n - 1),
                  0.2 * np.ones(n - 1)], [0, 1, -1]).tocsr()
    ref = sla.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    _pencil_solves(A, B, ref, 5, "SA", 1e-7 * 60, tol=1e-9)


def test_fem_pencil_f32():
    """The Q1 FEM pencil of ``chip_smoke.py`` phase 16 at 8^3, in f32 at
    tol 1e-5 with the smoke's settings: eigenvalues within 1e-4 of the
    closed form, ``X^T M X = I`` and the true residuals (f64 on the host)
    within 1.5 tol ||M^-1 K||."""
    import chip_smoke as CS

    K, M, ev, _ = CS.fem_q1(8)
    kw = dict(CS.SOLVE_KWARGS, k=6)
    wj, _, stj = jeigsh(K, M=M, tol=1e-5, seed=0, **kw)
    wt, Xt, stt = ptt.eigsh(K, M=M, tol=1e-5, seed=0, device="cpu", **kw)
    for w in (np.asarray(wj), wt):
        assert np.abs(np.sort(w) - ev[:6]).max() <= 1e-4
    X = Xt.astype(np.float64)
    M64 = M.astype(np.float64)
    assert np.abs(X.T @ (M64 @ X) - np.eye(6)).max() <= 1e-4
    R = K.astype(np.float64) @ X - (M64 @ X) * wt[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1.5e-5 * ev.max()
    mv_j, mv_t = int(stj["num_matvecs"]), stt["num_matvecs"]
    assert mv_j / 2 <= mv_t <= 2 * mv_j, (mv_t, mv_j)


@pytest.mark.parametrize("method,which", [
    (JMethod.GD_Olsen_plusK, "SA"), (JMethod.GD_plusK, "LA"),
    (JMethod.LOBPCG_OrthoBasis, "SA"), (JMethod.JDQMR_ETol, "LA")],
    ids=lambda v: getattr(v, "name", v))
def test_sweep_generalized_cases(method, which):
    # tests/test_sweep.py::test_sweep_generalized's grid (its fixture)
    n = 80
    A = sp.diags([np.linspace(1, 40, n), 0.5 * np.ones(n - 1),
                  0.5 * np.ones(n - 1)], [0, 1, -1]).tocsr()
    B = sp.diags(1.0 + np.linspace(0, 1, n)).tocsr()
    ref = np.sort(sla.eigh(A.toarray(), B.toarray(), eigvals_only=True))
    _pencil_solves(A, B, ref, 4, which, 1e-6 * 40, tol=1e-8,
                   method=method, maxMatvecs=9000)
