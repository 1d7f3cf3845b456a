"""The port's ``svds`` for the smallest singular values against the JAX
package's on the same numpy inputs, on the CPU: the ``tests/test_svds.py``
fixtures of the nn = 512 SM depth rule and of pure-augmented SM. The
helpers and the tolerances are ``tests/test_torch_svds.py``'s: each result
at its fixture's bar, matvecs within ``MV_SLACK`` = 2x of the JAX
package's."""

import numpy as np

from test_torch_svds import _both, _mv_parity, _one_torch_thread  # noqa: F401


def test_sm_depth_rule_nn512():
    """The depth rule at nn = 512 (the shallow side): exactly the planted
    near-null quadruple, to 1e-10, in both packages, and the port's fifth
    value 1.0 (the JAX package returns that slot as missing, NaN, here:
    ROADMAP Queue C). Stage 2 resolves the quadruple on the augmented
    operator with the refined extraction, whose f64 batch must be an SVD:
    the Gram's eigh cannot resolve these singular values."""
    rng = np.random.default_rng(0)
    nn = 512
    m = nn + 1
    sv = np.concatenate([np.full(4, 1.5e-9),
                         np.linspace(1.0, 50.0, nn - 4)])
    U, _ = np.linalg.qr(rng.normal(size=(m, nn)))
    V, _ = np.linalg.qr(rng.normal(size=(nn, nn)))
    A = (U * sv[None, :]) @ V.T
    t, j = _both(A, k=5, which="SM", tol=7e-12, maxiter=250000,
                 raise_for_unconverged=False)
    for _, s, _, _ in (t, j):
        tiny = np.sort(s)[np.sort(s) < 1e-6]
        assert len(tiny) == 4, np.sort(s)
        assert np.abs(tiny - 1.5e-9).max() < 1e-10
    assert abs(np.sort(t[1])[4] - 1.0) < 1e-6
    _mv_parity(t, j)


def test_augmented_rect_sm_honest():
    """Pure-augmented SM on a rectangular matrix: every finite value is a
    true singular value and no sigma ~ 0 artefact of the augmented
    operator's null space is reported (the junk rule and the power-step
    norm bound together), in both packages."""
    rng = np.random.default_rng(7907 * 0 + 40 + 3 * 30)
    sv = np.linspace(1.0, 20.0, 30)
    U = np.linalg.qr(rng.normal(size=(40, 30)))[0]
    V = np.linalg.qr(rng.normal(size=(30, 30)))[0]
    A = (U * sv[None, :]) @ V.T
    t, j = _both(A, k=3, which="SM", tol=1e-9, method="augmented",
                 maxiter=60000, raise_for_unconverged=False)
    for _, s, _, st in (t, j):
        good = np.isfinite(s) & np.isfinite(st["resnorms"])
        for v in s[good]:
            assert np.abs(sv - v).min() < 1e-6
        assert not np.any(s[good] < 0.5)
    _mv_parity(t, j)
