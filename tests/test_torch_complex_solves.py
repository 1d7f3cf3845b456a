"""Complex solves in the port against the JAX package on the same numpy
inputs, on the CPU: ``eigsh`` on the magnetic graph Laplacian (the
smoke's phases 24-25 at a small grid) through the chooser's banded
branch in complex64 and complex128 against the closed form; ``eigsh`` on
a complex Hermitian scatter (phase 26's kind) through a directly built
``ELLOperator``; ``svds`` on ``tests/test_svds.py::test_complex``'s
fixture and on the magnetic incidence ``[D; 0.1 I]`` (phase 27's kind),
LM and SM: values, ``Vh`` and triplet residuals.

Tolerances: eigenvalues within 1e-4 (complex64, tol 1e-5) and 1e-8
(complex128, tol 1e-10) of the closed form or of a dense solve, as the
smoke's phases hold them; true residuals within 1.5 tol ||A||; svds'
values within the bar ``tests/test_svds.py`` sets for its fixture and
1e-8 sigma_max (tol 1e-10) on the incidence; the matvecs within ``MV_SLACK``
= 2x of the JAX package's, as the other parity files hold them."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu
import primme_tpu_torch as ptt
import chip_smoke as CS
from primme_tpu import operators as JO

MV_SLACK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # beside parallel test workers, extra intra-op threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mv_parity(st_t, st_j, key="num_matvecs"):
    assert st_t[key] <= MV_SLACK * st_j[key], (st_t[key], st_j[key])


def _svds_matvecs(st):
    """Both stages' matvecs (a stage that did not run has no counters)."""
    return sum(st.get(f"stage{i}_num_matvecs", 0) for i in (1, 2))


@pytest.mark.parametrize("N", [8, 11])
@pytest.mark.parametrize("dtype,tol,bar", [(np.complex64, 1e-5, 1e-4),
                                           (np.complex128, 1e-10, 1e-8)])
def test_magnetic_laplacian_banded(N, dtype, tol, bar):
    L, ev, anorm = CS.magnetic_laplacian(N, dtype=dtype)
    top, perm = ptt.rcm_banded(L)
    jop, jperm = JO.rcm_banded(L)
    assert isinstance(top, ptt.BandedOperator) and perm is None is jperm
    assert top.offsets == jop.offsets and len(top.offsets) == 11
    assert top.dtype == getattr(torch, np.dtype(dtype).name)
    assert np.array_equal(top.vals.numpy(), np.asarray(jop.vals))
    kw = dict(tol=tol, seed=0, **CS.SOLVE_KWARGS)
    wt, Vt, st = ptt.eigsh(L, device="cpu", **kw)
    wj, _, sj = primme_tpu.eigsh(L, **kw)
    assert Vt.dtype == np.dtype(dtype)
    for w in (wt, np.asarray(wj)):
        assert np.abs(np.sort(w) - ev[:10]).max() <= bar
    V = Vt.astype(np.complex128)
    R = L.astype(np.complex128) @ V - V * wt[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1.5 * tol * anorm
    assert st["probe_verified"] == 1 and st["probe_exhausted"] == 0
    _mv_parity(st, sj)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_scatter_through_ell(dtype):
    n = 3000
    A = CS.complex_scattered_matrix(n, 0, dtype=dtype)
    assert ptt.rcm_banded(A) is None
    ref = np.linalg.eigvalsh(A.toarray().astype(np.complex128))[:10]
    top, jop = ptt.ELLOperator.from_scipy(A), JO.ELLOperator.from_scipy(A)
    kw = dict(tol=1e-5, seed=0, **CS.SOLVE_KWARGS)
    wt, Vt, st = ptt.eigsh(top, device="cpu", **kw)
    wj, _, sj = primme_tpu.eigsh(jop, **kw)
    for w in (wt, np.asarray(wj)):
        assert np.abs(np.sort(w) - ref).max() <= 1e-4
    V = Vt.astype(np.complex128)
    R = A.astype(np.complex128) @ V - V * wt[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1.5e-5 * CS.gershgorin(A)
    _mv_parity(st, sj)


def test_svds_complex_fixture():
    # tests/test_svds.py::test_complex, through both packages
    rng = np.random.default_rng(4)
    A = rng.normal(size=(100, 70)) + 1j * rng.normal(size=(100, 70))
    sref = np.linalg.svd(A, compute_uv=False)
    kw = dict(k=4, which="LM", tol=1e-9, return_stats=True)
    runs = ptt.svds(A, device="cpu", **kw), primme_tpu.svds(A, **kw)
    for U, s, Vt, _ in runs:
        U, s, Vt = (np.asarray(x) for x in (U, s, Vt))
        assert U.dtype == Vt.dtype == np.complex128
        assert np.abs(np.sort(s) - np.sort(sref)[-4:]).max() < 1e-7 * sref[0]
        R = A @ Vt.conj().T - U * s[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-6 * sref[0]
        assert np.abs(Vt @ Vt.conj().T - np.eye(4)).max() < 1e-8
    assert _svds_matvecs(runs[0][3]) <= MV_SLACK * _svds_matvecs(runs[1][3])


@pytest.mark.parametrize("which,k", [("LM", 4), ("SM", 6)])
def test_svds_magnetic_incidence(which, k):
    A, sv = CS.magnetic_svd_matrix(8)
    ref = sv[-k:] if which == "LM" else sv[:k]
    kw = dict(k=k, which=which, tol=1e-10, seed=0, return_stats=True)
    Ut, st_, Vht, tst = ptt.svds(A, device="cpu", **kw)
    Uj, sj, Vhj, jst = primme_tpu.svds(A, **kw)
    for U, s, Vh in ((Ut, st_, Vht), (np.asarray(Uj), np.asarray(sj),
                                      np.asarray(Vhj))):
        assert np.abs(np.sort(s) - ref).max() <= 1e-8 * sv[-1]
        V = Vh.conj().T
        R1 = A @ V - U * s[None, :]
        R2 = A.conj().T @ U - V * s[None, :]
        res = np.sqrt(np.linalg.norm(R1, axis=0) ** 2
                      + np.linalg.norm(R2, axis=0) ** 2)
        assert res.max() <= 10 * 1e-10 * sv[-1]
        assert np.abs(Vh @ V - np.eye(k)).max() <= 1e-8
        assert np.abs(U.conj().T @ U - np.eye(k)).max() <= 1e-8
    if which == "LM":
        # Vh is V^H, as the reference's: the same rows up to a phase (the
        # LM values are simple; SM's come in pairs)
        assert np.abs(np.abs(Vht @ np.asarray(Vhj).conj().T)
                      - np.eye(k)).max() <= 1e-6
    assert _svds_matvecs(tst) <= MV_SLACK * _svds_matvecs(jst)


def test_complex_permuted_band_with_v0_and_lock():
    # a complex Hermitian band in a random node order takes the chooser's
    # RCM branch (a permutation); v0 and lock= keep their complex type
    # through it, in both packages
    n = 600
    rng = np.random.default_rng(8)
    o1 = rng.normal(size=n - 1) + 1j * rng.normal(size=n - 1)
    o2 = 0.3 * (rng.normal(size=n - 2) + 1j * rng.normal(size=n - 2))
    B = sp.diags([np.linspace(1.0, 60.0, n), o1, o1.conj(), o2, o2.conj()],
                 [0, 1, -1, 2, -2]).tocsr()
    p = rng.permutation(n)
    A = B[p][:, p].tocsr()
    top, perm = ptt.rcm_banded(A)
    assert isinstance(top, ptt.BandedOperator) and perm is not None
    w, Z = np.linalg.eigh(A.toarray())
    lock = Z[:, :1]
    v0 = rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    kw = dict(k=3, which="SA", tol=1e-9, lock=lock, v0=v0,
              return_stats=True)
    for wt, V, st in (ptt.eigsh(A, device="cpu", **kw),
                      primme_tpu.eigsh(A, **kw)):
        V = np.asarray(V)
        assert V.dtype == np.complex128
        assert np.abs(np.sort(np.asarray(wt)) - w[1:4]).max() <= 1e-7 * w[-1]
        assert np.abs(lock.conj().T @ V).max() <= 1e-7
        R = A @ V - V * np.asarray(wt)[None, :]
        assert np.linalg.norm(R, axis=0).max() <= 10 * 1e-9 * w[-1]


def test_svds_complex_orthov0_and_convtest():
    # orthogonality constraints and a user test on complex input: the
    # triplets after the largest, with the right vector given
    rng = np.random.default_rng(4)
    A = rng.normal(size=(100, 70)) + 1j * rng.normal(size=(100, 70))
    _, sref, Vh = np.linalg.svd(A)
    seen = []

    def convtest(svals, resnorms, tol, anorm):
        seen.append(svals.dtype)
        return resnorms < 1e-9 * anorm

    kw = dict(k=3, which="LM", tol=1e-9, orthov0=Vh[:1].conj().T)
    Ut, st_, Vht = ptt.svds(A, device="cpu", convtest=convtest, **kw)
    Uj, sj, Vhj = primme_tpu.svds(A, **kw)
    assert seen and all(not torch.empty((), dtype=d).is_complex()
                        for d in seen)
    for U, s, Vh_ in ((Ut, st_, Vht), (np.asarray(Uj), np.asarray(sj),
                                       np.asarray(Vhj))):
        assert np.abs(np.sort(s) - np.sort(sref[1:4])).max() < 1e-7 * sref[0]
        assert np.abs(Vh_ @ Vh[0].conj()).max() < 1e-7
        R = A @ Vh_.conj().T - U * s[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-6 * sref[0]
