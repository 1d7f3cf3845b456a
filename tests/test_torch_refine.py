"""The f64 refinement route: ``refine_eigsh`` and ``ChebyshevPrecond`` of
the port against the JAX package's, on the same numpy inputs.

``tests/test_refine.py``'s three fixtures go through each package's f32
``eigsh`` and then its ``refine_eigsh`` (the port on ``device="cpu"``);
each is held to that file's own bounds, the two packages' eigenvalues to
each other within 1e-10 relative, and the port's ``num_refine_iters`` to
within 2x of the JAX package's (the f32 starts and the ||A|| estimate's
random start differ, so the counts are not equal).

``ChebyshevPrecond.matmat`` with a fixed interval runs the same
recurrence: f64 agrees to 1e-12 relative and f32 to 1e-5 relative to
max|z| (seven block products, rounding in another order).
``from_operator``'s interval comes from 20 power iterations from
different random starts: its upper end agrees to 2%.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import primme_tpu as pt
from primme_tpu.refine import refine_eigsh as jrefine
import primme_tpu_torch as ptt
from primme_tpu_torch.convert import chebyshev_from_jax, stencil_from_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _iters_within_2x(st_t, st_j):
    it_t, it_j = st_t["num_refine_iters"], int(st_j["num_refine_iters"])
    assert it_j / 2 <= it_t <= 2 * it_j, (it_t, it_j)


def test_refine_tridiag_to_1e12():
    n = 1000
    d = np.linspace(1, 100, n)
    A = sp.diags([d, 0.3 * np.ones(n - 1), 0.3 * np.ones(n - 1)],
                 [0, 1, -1]).tocsr()
    ref = np.sort(np.linalg.eigvalsh(A.toarray()))[:5]
    _, vj = pt.eigsh(A, k=5, which="SA", tol=1e-5, dtype=np.float32,
                     raise_for_unconverged=False)
    evj, _, stj = jrefine(A, vj, tol=1e-12, return_stats=True)
    _, vt = ptt.eigsh(A, k=5, which="SA", tol=1e-5, dtype=np.float32,
                      raise_for_unconverged=False, device="cpu")
    ev, X, st = ptt.refine_eigsh(A, vt, tol=1e-12, return_stats=True,
                                 device="cpu")
    assert np.abs(ev - ref).max() < 1e-10
    R = A @ X - X * ev[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1e-11 * st["anorm_estimate"] \
        * 10
    assert np.abs(ev - np.asarray(evj)).max() < 1e-10 * 100
    _iters_within_2x(st, stj)


def test_refine_laplacian_cheb_1e11():
    nx = 16
    ax = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort((ax[:3, None, None] + ax[None, :3, None]
                   + ax[None, None, :3]).ravel())[:6]
    Aj = pt.Stencil3DOperator(nx, nx, nx, dtype=jnp.float32)
    _, vj = pt.eigsh(Aj, k=6, which="SA", tol=1e-5,
                     raise_for_unconverged=False)
    A64j = pt.Stencil3DOperator(nx, nx, nx, dtype=jnp.float64)
    Kj = pt.ChebyshevPrecond.from_operator(A64j, degree=8)
    evj, _, stj = jrefine(A64j, vj, tol=1e-11, OPinv=Kj, return_stats=True)

    At = stencil_from_jax(Aj, "cpu")
    _, vt = ptt.eigsh(At, k=6, which="SA", tol=1e-5,
                      raise_for_unconverged=False, device="cpu")
    A64 = stencil_from_jax(A64j, "cpu")
    K = ptt.ChebyshevPrecond.from_operator(A64, degree=8)
    ev, X, st = ptt.refine_eigsh(A64, vt, tol=1e-11, OPinv=K,
                                 return_stats=True, device="cpu")
    assert np.abs(ev - lam).max() < 1e-12
    assert st["resnorms"].max() <= 1e-11 * st["anorm_estimate"]
    assert st["num_refine_iters"] < 100
    assert np.abs(ev - np.asarray(evj)).max() < 1e-12
    _iters_within_2x(st, stj)
    assert abs(float(K.b) - float(Kj.b)) <= 0.02 * float(Kj.b)
    assert float(K.a) == pytest.approx(0.05 * float(K.b))


def test_refine_largest():
    n = 500
    rng = np.random.default_rng(1)
    A = rng.normal(size=(n, n))
    A = (A + A.T) / 2
    ref = np.sort(np.linalg.eigvalsh(A))
    _, vj = pt.eigsh(A, k=4, which="LA", tol=1e-4, dtype=np.float32,
                     raise_for_unconverged=False)
    evj, _, stj = jrefine(A, vj, tol=1e-12, which="LA", return_stats=True)
    _, vt = ptt.eigsh(A, k=4, which="LA", tol=1e-4, dtype=np.float32,
                      raise_for_unconverged=False, device="cpu")
    ev, X, st = ptt.refine_eigsh(A, vt, tol=1e-12, which="LA",
                                 return_stats=True, device="cpu")
    assert np.abs(np.sort(ev) - ref[-4:]).max() < 1e-10
    assert np.abs(np.sort(ev) - np.sort(np.asarray(evj))).max() < 1e-10
    _iters_within_2x(st, stj)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_chebyshev_matmat(prec, k):
    nd, jd = {"f32": (np.float32, jnp.float32),
              "f64": (np.float64, jnp.float64)}[prec]
    Aj = pt.Stencil3DOperator(8, 9, 10, dtype=jd)
    Kj = pt.ChebyshevPrecond(Aj, (0.6, 12.1), degree=8, sigma=0.3)
    Kt = chebyshev_from_jax(Kj, stencil_from_jax(Aj, "cpu"))
    assert (Kt.degree, float(Kt.a), float(Kt.b), float(Kt.sigma)) == (
        8, float(Kj.a), float(Kj.b), float(Kj.sigma))
    X = np.random.default_rng(k).standard_normal((720, k)).astype(nd)
    zj = np.asarray(Kj.matmat(jnp.asarray(X)), np.float64)
    zt = Kt.matmat(torch.as_tensor(X))
    assert zt.dtype == torch.from_numpy(X).dtype
    tol = 1e-5 if prec == "f32" else 1e-12
    assert np.abs(zt.numpy() - zj).max() <= tol * np.abs(zj).max()


def test_refine_needs_a_card_unless_asked(monkeypatch):
    # an entry point of the port runs on the card unless asked otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ptt.refine_eigsh(np.eye(4), np.eye(4)[:, :1], tol=1e-10)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ptt.refine_eigsh(np.eye(4), np.eye(4)[:, :1], tol=1e-10,
                         device="auto")
