"""The port's ``svds`` with constraints and user convergence tests against
the JAX package's on the same numpy inputs, on the CPU (the
``tests/test_svds.py`` fixtures ``orthou0``/``orthov0`` and ``convtest``),
and ``eigsh(convtest=)``; the helpers, the ``rect`` fixture and the
tolerances are ``tests/test_torch_svds.py``'s: each result at its
fixture's bar, matvecs within ``MV_SLACK`` = 2x of the JAX package's."""

import scipy.sparse as sp

import numpy as np
import torch

import jax.numpy as jnp

import primme_tpu
import primme_tpu_torch as ptt
from test_torch_svds import (MV_SLACK, _both, _mv, _mv_parity,  # noqa: F401
                             _one_torch_thread, rect)


def test_orthou0_deflated_resume(rect):
    A, sv = rect
    (U1, s1, Vt1, _), j1 = _both(A, k=3, which="LM", tol=1e-10)
    t2, j2 = _both(A, k=3, which="LM", tol=1e-10, orthou0=U1,
                   orthov0=Vt1.conj().T)
    assert np.abs(np.sort(s1) - sv[-3:]).max() < 1e-8 * sv[-1]
    for U2, s2, Vt2, _ in (t2, j2):
        assert np.abs(np.sort(s2) - sv[-6:-3]).max() < 1e-8 * sv[-1]
        assert np.abs(U1.T @ U2).max() < 1e-6
        assert np.abs(Vt1 @ Vt2.T).max() < 1e-6
    _mv_parity(t2, j2)


def test_orthov0_one_sided(rect):
    A, sv = rect
    U1, s1, Vt1 = ptt.svds(A, k=2, which="LM", tol=1e-10, device="cpu")
    # one side given, as the right argument or swapped into the left one
    for kw in ({"orthov0": Vt1.conj().T}, {"orthou0": Vt1.conj().T}):
        t, j = _both(A, k=2, which="LM", tol=1e-10, **kw)
        for _, s2, _, _ in (t, j):
            assert np.abs(np.sort(s2) - sv[-4:-2]).max() < 1e-8 * sv[-1]
        _mv_parity(t, j)


def test_svds_user_convtest(rect):
    """A user test replaces each stage's default: an accept-all test ends
    the solve at once despite tol=1e-12, with visibly looser residuals
    than the default test's run (the reference's assertions, on both
    packages), the port's test taking tensors."""
    A, sv = rect

    def accept_all_t(svals, resnorms, tol, anorm):
        assert isinstance(svals, torch.Tensor)
        assert isinstance(resnorms, torch.Tensor)
        return torch.ones(resnorms.shape, dtype=torch.bool)

    def accept_all_j(svals, resnorms, tol, anorm):
        return jnp.ones(resnorms.shape, bool)

    kw = dict(k=3, which="LM", tol=1e-12, return_stats=True)
    loose = (ptt.svds(A, convtest=accept_all_t, raise_for_unconverged=False,
                      device="cpu", **kw),
             primme_tpu.svds(A, convtest=accept_all_j,
                             raise_for_unconverged=False, **kw))
    tight = (ptt.svds(A, device="cpu", **kw), primme_tpu.svds(A, **kw))
    for (_, _, _, st_l), (_, _, _, st_t) in zip(loose, tight):
        assert _mv(st_l, probe=False) < _mv(st_t, probe=False)
        assert (np.max(st_l["resnorms"])
                > 10 * max(np.max(st_t["resnorms"]), 1e-300))
    _mv_parity(*tight)


# --- eigsh(convtest=) --------------------------------------------------------

def test_eigsh_convtest_parity():
    """``eigsh(convtest=)`` replaces the residual test in both packages: a
    test 1e3 times looser than ``tol`` ends the solve sooner than the
    default one, and the port's pairs are as loose as the JAX package's
    (eigenvalue errors and residuals within 10x of its; both packages
    accept locked pairs whose vectors then drift well past the test's
    bar, about 1e-2 here), with matvecs within 2x; the port's test gets
    tensors and host floats."""
    n = 300
    A = sp.diags([np.linspace(1, 100, n), 0.3 * np.ones(n - 1),
                  0.3 * np.ones(n - 1)], [0, 1, -1]).tocsr()
    calls = []

    def loose_t(evals, resnorms, tol, anorm):
        calls.append((type(evals), type(resnorms), type(tol), type(anorm)))
        return resnorms <= 1e3 * tol

    def loose_j(evals, resnorms, tol, anorm):
        return resnorms <= 1e3 * tol

    kw = dict(k=4, which="SA", tol=1e-10, return_stats=True,
              raise_for_unconverged=False)
    w, V, st = ptt.eigsh(A, convtest=loose_t, device="cpu", **kw)
    wj, Vj, stj = primme_tpu.eigsh(A, convtest=loose_j, **kw)
    _, _, st0 = ptt.eigsh(A, device="cpu", **kw)
    assert calls and set(calls) == {(torch.Tensor, torch.Tensor, float,
                                     float)}
    ref = np.linalg.eigvalsh(A.toarray())[:4]
    wj, Vj = np.asarray(wj), np.asarray(Vj)
    err, errj = (np.abs(np.sort(x) - ref).max() for x in (w, wj))
    res, resj = (np.linalg.norm(A @ X - X * x[None, :], axis=0).max()
                 for x, X in ((w, V), (wj, Vj)))
    assert err <= 10 * errj and res <= 10 * resj
    assert st["num_matvecs"] < st0["num_matvecs"]
    mv, mvj = st["num_matvecs"], int(stj["num_matvecs"])
    assert mvj / MV_SLACK <= mv <= MV_SLACK * mvj, (mv, mvj)
