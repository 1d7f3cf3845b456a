"""Refined and harmonic extraction and the JDQR skew-Q projector: the
port's (``primme_tpu_torch/core/linalg.py``, ``core/inner.py``) against
the JAX package's on the same numpy inputs, and the solves that use them.

Tolerances: the small dense kernels (QR R factors, the block-diagonal
``eigh``) agree to 1e-10 relative in f64 (LAPACK in both, sums in another
order); a QR's R is compared through ``R^T R`` (the factor's row signs are
the library's choice), coefficient vectors through their projectors. The
refined vectors are the smallest right singular vectors of ``[H - tau I;
G]``, which the JAX package takes from an SVD of ``C`` and the port
from an f64 ``eigh`` of ``C^H C``: the rounding error is eps ||C|| over
the gap to the next singular value for the first and eps ||C||^2 over
the gap of the squares for the second; on these unconverged states the
two read 1e-11 to 1e-9 apart in f64, so they are held to 1e-8. In f32
the port's is held to be at least as accurate as the JAX package's. The inner solve in f64 runs the same recurrences, so its
counts are equal and its correction agrees to 1e-9. Solves hold the
fixture's own bound (eigenvalues within 1e-6 relative of LAPACK, as
``tests/test_eigsh.py`` does) and the matvec counts to ``mv_slack=2`` of
the JAX package's: parity is never bitwise where random numbers enter.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from primme_tpu import eigsh as jeigsh, Method as JMethod
from primme_tpu import params as jp
from primme_tpu.core import inner as ji
from primme_tpu.core import linalg as jl
from primme_tpu.core import solver as js
from primme_tpu.operators import DenseOperator, JacobiPrecond as JJacobi
from primme_tpu.params import Target as JTarget
import primme_tpu_torch as ptt
from primme_tpu_torch.convert import params_from_jax
from primme_tpu_torch.core import inner as ti
from primme_tpu_torch.core import linalg as tl
from primme_tpu_torch.core import solver as ts
from primme_tpu_torch.params import Target as TTarget
from test_torch_problems import tridiag_fixture

TOL = 1e-10


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


def _basis_state(seed, n=200, mmax=12, b=9):
    """An orthonormal basis V (inactive columns zero), W = A V for a
    symmetric A with a spread spectrum, and H = V^T W."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.linspace(-3.0, 9.0, n)) @ Q.T
    V = np.zeros((n, mmax))
    V[:, :b] = np.linalg.qr(rng.standard_normal((n, b)))[0]
    W = A @ V
    H = V.T @ W
    return A, V, W, 0.5 * (H + H.T), b


def test_shifted_and_complement_qr_R():
    A, V, W, H, b = _basis_state(0)
    t = torch.as_tensor
    Rj = np.asarray(jl.shifted_qr_R(jnp.asarray(W), jnp.asarray(V),
                                    jnp.int32(b), jnp.float64(0.7)))
    Rt = tl.shifted_qr_R(t(W), t(V), b,
                         torch.tensor(0.7, dtype=torch.float64)).numpy()
    _close(Rj.T @ Rj, Rt.T @ Rt)
    assert np.all(Rt[b:, :] == 0) and np.all(Rt[:, b:] == 0)
    Gj = np.asarray(jl.complement_qr_R(jnp.asarray(V), jnp.asarray(W),
                                       jnp.asarray(H), jnp.int32(b)))
    Gt = tl.complement_qr_R(t(V), t(W), t(H), b).numpy()
    _close(Gj.T @ Gj, Gt.T @ Gt)


def _projector_close(Zj, Zt, active, tol=TOL):
    for j in np.nonzero(active)[0]:
        _close(np.outer(Zj[:, j], Zj[:, j]), np.outer(Zt[:, j], Zt[:, j]),
               tol)


@pytest.mark.parametrize("target", ["smallest", "closest_abs"])
@pytest.mark.parametrize("cluster", [False, True])
def test_solve_H_refined(target, cluster):
    A, V, W, H, b = _basis_state(1)
    t = torch.as_tensor
    G = np.asarray(jl.complement_qr_R(jnp.asarray(V), jnp.asarray(W),
                                      jnp.asarray(H), jnp.int32(b)))
    sh = np.array([1.5])
    kw_j, kw_t = {}, {}
    if cluster:    # the prepare_vecs gap test on
        kw_j = kw_t = dict(anorm=9.0, conv_eps=1e-6)
    sj = jl.solve_H_refined(jnp.asarray(H), jnp.asarray(G), jnp.int32(b),
                            JTarget(target), jnp.asarray(sh), jnp.int32(0),
                            **kw_j)
    st = tl.solve_H_refined(t(H), torch.tensor(G), b, TTarget(target), t(sh),
                            0, **kw_t)
    act = st.active.numpy()
    assert np.array_equal(np.asarray(sj.active), act) and act.sum() == b
    _close(np.asarray(sj.hvals)[act], st.hvals.numpy()[act], 1e-8)
    _projector_close(np.asarray(sj.hvecs), st.hvecs.numpy(), act, 1e-8)
    assert np.all(st.hvecs.numpy()[:, ~act] == 0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_H_refined_f32_accuracy(seed):
    """The f32 extraction: the port takes its batch from an f64 ``eigh``
    of the Grams ``C^H C``, the JAX package from an f32 SVD of ``C``.
    Against the f64 extraction of the same rounded inputs, each of the
    port's refined vectors (through its projector) is at least as
    accurate as the JAX package's, to 1e-6 (the f32 rounding of the
    results themselves)."""
    A, V, W, H, b = _basis_state(seed)
    G = np.asarray(jl.complement_qr_R(jnp.asarray(V), jnp.asarray(W),
                                      jnp.asarray(H), jnp.int32(b)))
    H32, G32 = H.astype(np.float32), G.astype(np.float32)
    args = (jnp.int32(b), JTarget("closest_abs"))
    s64 = jl.solve_H_refined(jnp.asarray(H32, jnp.float64),
                             jnp.asarray(G32, jnp.float64), *args,
                             jnp.asarray([1.5]), jnp.int32(0))
    sj = jl.solve_H_refined(jnp.asarray(H32), jnp.asarray(G32), *args,
                            jnp.asarray([1.5], jnp.float32), jnp.int32(0))
    st = tl.solve_H_refined(torch.tensor(H32), torch.tensor(G32), b,
                            TTarget("closest_abs"), torch.tensor([1.5]), 0)
    act = st.active.numpy()
    assert act.sum() == b and st.hvecs.dtype == torch.float32

    def errs(Z):
        Z = np.asarray(Z, np.float64)[:, act]
        Z6 = np.asarray(s64.hvecs)[:, act]
        return np.array([np.abs(np.outer(Z6[:, j], Z6[:, j])
                                - np.outer(Z[:, j], Z[:, j])).max()
                         for j in range(b)])

    e_t, e_j = errs(st.hvecs.numpy()), errs(sj.hvecs)
    assert np.all(e_t <= e_j + 1e-6), (e_t, e_j)


@pytest.mark.parametrize("target", ["smallest", "closest_abs"])
def test_solve_H_harmonic(target):
    A, V, W, H, b = _basis_state(2)
    t = torch.as_tensor
    sh = np.array([1.5])
    R = np.asarray(jl.shifted_qr_R(jnp.asarray(W), jnp.asarray(V),
                                   jnp.int32(b), jnp.float64(sh[0])))
    sj = jl.solve_H_harmonic(jnp.asarray(H), jnp.asarray(R), jnp.int32(b),
                             JTarget(target), jnp.asarray(sh), jnp.int32(0))
    st = tl.solve_H_harmonic(t(H), torch.tensor(R), b, TTarget(target),
                             t(sh), 0)
    act = st.active.numpy()
    assert np.array_equal(np.asarray(sj.active), act) and act.sum() == b
    _close(np.asarray(sj.hvals)[act], st.hvals.numpy()[act])
    _projector_close(np.asarray(sj.hvecs), st.hvecs.numpy(), act)


def test_orthonormalize_coeffs():
    rng = np.random.default_rng(3)
    C = rng.standard_normal((10, 6))
    C[:, 4] = C[:, 0] + C[:, 1]              # dependent
    valid = np.array([True] * 5 + [False])
    Qj, okj = jl.orthonormalize_coeffs(jnp.asarray(C), jnp.asarray(valid),
                                       1e-16)
    Qt, okt = tl.orthonormalize_coeffs(torch.as_tensor(C),
                                       torch.as_tensor(valid), 1e-16)
    assert np.array_equal(np.asarray(okj), okt.numpy())
    assert int(okt.sum()) == 4
    Qj, Qt = np.asarray(Qj), Qt.numpy()
    _close(Qj @ Qj.T, Qt @ Qt.T)


class _Dense(ptt.LinearOperator):
    def __init__(self, A):
        super().__init__()
        self.register_buffer("A", torch.as_tensor(A))
        self.shape = tuple(A.shape)
        self.dtype = self.A.dtype

    def matmat(self, X):
        return self.A @ X


def test_jdqr_skew_projector_inner_solve():
    """JDQR with a preconditioner and locked vectors: the right projector
    is the skew projector (I - K^{-1}Q M^{-1} Q^T), M LU-factorized."""
    rng = np.random.default_rng(5)
    n, blk, nl = 300, 1, 3
    Qr = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Qr * np.linspace(0.5, 30.0, n)) @ Qr.T + np.diag(
        np.linspace(1.0, 5.0, n))
    A = 0.5 * (A + A.T)
    w, U = np.linalg.eigh(A)
    p = jp.set_method(jp.Method.JDQR,
                      jp.PrimmeParams(n=n, num_evals=5, max_block_size=blk,
                                      eps=1e-8), has_precond=True)
    cfg_j = js.make_config(p)
    cfg_t = ts.make_config(params_from_jax(p))
    assert cfg_t.skewQ and cfg_t.rightQ and cfg_t.locking
    evecs = np.zeros((n, cfg_j.lockmax))
    evecs[:, :nl] = U[:, :nl]
    V = np.linalg.qr(U[:, nl:nl + 6] + 1e-3 * rng.standard_normal((n, 6)))[0]
    V -= evecs @ (evecs.T @ V)
    V = np.linalg.qr(V)[0]
    hw, Z = np.linalg.eigh(V.T @ A @ V)
    X = V @ Z[:, :blk]
    lam = hw[:blk]
    R = A @ X - X * lam
    res = np.linalg.norm(R, axis=0)
    d = np.diag(A).copy()
    stats = dict(num_outer_iterations=4, anorm_estimate=30.0,
                 num_matvecs=80)

    import types
    f = lambda a: jnp.asarray(a, jnp.float64)   # noqa: E731
    sj = types.SimpleNamespace(
        num_locked=jnp.int32(nl), evecs=f(evecs), Bevecs=f(evecs),
        stats=types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in
                                       stats.items()}))
    out_j = ji.jdqmr_inner_solve(
        cfg_j, DenseOperator(f(A)), None, JJacobi(f(d)), sj, f(X), f(X),
        f(R), f(lam), f(res), jnp.ones((blk,), bool), f(1e-8 * 30.0),
        evals=f(lam))
    t = torch.as_tensor
    st = types.SimpleNamespace(num_locked=nl, evecs=t(evecs), Bevecs=None,
                               stats=types.SimpleNamespace(**stats))
    out_t = ti.jdqmr_inner_solve(
        cfg_t, _Dense(A), None, ptt.JacobiPrecond(d), st, t(X), t(X), t(R),
        t(lam), t(res), torch.ones((blk,), dtype=torch.bool), 1e-8 * 30.0,
        evals=t(lam))
    sol_j, its_j, nmv_j, nprec_j = (np.asarray(x) for x in out_j)
    sol_t, its_t, nmv_t, nprec_t, trace_t = out_t
    assert trace_t is None      # no inner_trace_cap, no step buffer
    assert (int(its_j), int(nmv_j), int(nprec_j)) == (its_t, nmv_t, nprec_t)
    assert its_t > 1
    sol_t = sol_t.numpy()
    assert np.abs(sol_t - sol_j).max() <= 1e-9 * np.abs(sol_j).max()


def _closest(ref, sigma, k):
    return np.sort(ref[np.argsort(np.abs(ref - sigma))][:k])


def _both_solves(A, **kw):
    wj, _, stj = jeigsh(A, raise_for_unconverged=False, return_stats=True,
                        **kw)
    kw = {k: (v.name if isinstance(v, JMethod) else v) for k, v in kw.items()}
    wt, Xt, stt = ptt.eigsh(A, raise_for_unconverged=False, device="cpu",
                            return_stats=True, **kw)
    return np.sort(np.asarray(wj)), int(stj["num_matvecs"]), \
        np.sort(wt), Xt, stt


def _within_slack(mv_t, mv_j, slack=2.0):
    assert mv_j / slack <= mv_t <= slack * mv_j, (mv_t, mv_j)


# tests/test_eigsh.py's solves: projections_interior (both projections),
# refined_extreme, jdqmr_interior, and JDQR + Jacobi with its locking
SOLVES = {
    "interior_refined": dict(k=5, which="SM", sigma=50.0, tol=1e-9,
                             method=JMethod.GD_plusK, projection="refined",
                             maxMatvecs=6000),
    "interior_harmonic": dict(k=5, which="SM", sigma=50.0, tol=1e-9,
                              method=JMethod.GD_plusK, projection="harmonic",
                              maxMatvecs=6000),
    "refined_extreme": dict(k=5, which="SA", tol=1e-9,
                            projection="refined", method=JMethod.GD_plusK,
                            maxMatvecs=3000),
    "jdqmr_interior": dict(k=5, which="SM", sigma=50.0, tol=1e-9,
                           method=JMethod.JDQMR, maxMatvecs=8000),
    "jdqr_jacobi_interior": dict(k=5, which="SM", sigma=50.0, tol=1e-9,
                                 method=JMethod.JDQR, jacobi=True,
                                 maxMatvecs=8000),
    "jdqr_jacobi_smallest": dict(k=5, which="SA", tol=1e-9,
                                 method=JMethod.JDQR, jacobi=True,
                                 maxMatvecs=8000),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_eigsh_projection_and_jdqr_solves(case):
    A, ref = tridiag_fixture()
    kw = SOLVES[case]
    wj, mv_j, wt, Xt, stt = _both_solves(A, **kw)
    # tests/test_eigsh.py's bounds: 1e-6 relative for interior targets,
    # 1e-7 for extreme ones
    if "sigma" in kw:
        expect, bound = _closest(ref, kw["sigma"], kw["k"]), 1e-6
    else:
        expect, bound = ref[:kw["k"]], 1e-7
    scale = max(1.0, np.abs(expect).max())
    assert np.abs(wt - expect).max() < bound * scale
    assert np.abs(wj - expect).max() < bound * scale
    _within_slack(stt["num_matvecs"], mv_j)
