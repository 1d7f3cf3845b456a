"""The port's ``svds`` with a preconditioner, a numeric target and
rectangular sparse input against the JAX package's on the same numpy
inputs, on the CPU: the ``tests/test_svds.py`` fixtures ``precAHA`` and a
numeric ``which``, and the rectangular sparse fixture past the densify
rule (``chip_smoke.grounded_incidence`` at N = 21: 35,721 x 9,261, an
``ELLOperator`` on the sliced-ELL layouts of ``A`` and ``A^T``, held to its
closed form within 1e-8 sigma_max and its triplet residuals to
10 tol ||A||). The helpers, the ``rect`` fixture and the other tolerances
are ``tests/test_torch_svds.py``'s: each result at its fixture's bar,
matvecs within ``MV_SLACK`` = 2x of the JAX package's."""

import numpy as np

import primme_tpu
import primme_tpu_torch as ptt
from test_torch_svds import (_both, _mv_parity,  # noqa: F401
                             _one_torch_thread, rect)
from chip_smoke import grounded_incidence


def test_svds_precond_aha(rect):
    A, sv = rect
    d = np.asarray((A * A).sum(axis=0)).ravel()  # diag(A^T A)
    t, j = _both(A, k=5, which="LM", tol=1e-9,
                 precAHA=ptt.JacobiPrecond(d),
                 jax_kw={"precAHA": primme_tpu.JacobiPrecond(d)})
    for _, s, _, st in (t, j):
        assert np.abs(np.sort(s) - sv[-5:]).max() < 1e-7 * sv[-1]
        assert st["stage1_num_preconds"] > 0
    _mv_parity(t, j)


def test_svds_sigma_closest(rect):
    A, sv = rect
    target = float(sv[len(sv) // 2])
    t, j = _both(A, k=3, which=target, tol=1e-9)
    expect = sv[np.argsort(np.abs(sv - target))][:3]
    for _, s, _, _ in (t, j):
        assert np.abs(np.sort(s) - np.sort(expect)).max() < 1e-6 * sv[-1]
    _mv_parity(t, j)


def test_rectangular_sparse_incidence():
    """The grounded incidence matrix at N = 21 (35,721 x 9,261, past the
    densify rule): the port's ``ELLOperator`` keeps the shape, and the
    hybrid LM solve holds the closed form and the triplet residuals, as
    the JAX package's does."""
    A, sv = grounded_incidence(21)
    op = ptt.aslinearoperator(A)
    assert isinstance(op, ptt.ELLOperator) and op.shape == A.shape
    tol = 1e-8
    t, j = _both(A, k=4, which="LM", tol=tol)
    anorm = sv[-1]
    for U, s, Vt, _ in (t, j):
        assert np.abs(np.sort(s) - sv[-4:]).max() <= 1e-8 * anorm
        R1 = A @ Vt.T - U * s[None, :]
        R2 = A.T @ U - Vt.T * s[None, :]
        res = np.sqrt((R1 ** 2).sum(axis=0) + (R2 ** 2).sum(axis=0))
        assert res.max() <= 10 * tol * anorm
        assert np.abs(U.T @ U - np.eye(4)).max() < 1e-8
    _mv_parity(t, j)
