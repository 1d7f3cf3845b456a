"""The port's two-stage ``svds`` against the JAX package's on the same
numpy inputs, on the CPU: the ``tests/test_svds.py`` fixtures of the
hybrid (LM and SM), each stage alone, the wide (``A A^T``) case and sparse
input, the ``SvdsParams`` reflection and ``svds_from_params`` through
``convert.svds_params_from_jax``, and the refusals. The complex fixture
is in ``test_torch_complex.py``; the other fixtures of that file that
read no file are in
``test_torch_svds_constraints.py``, ``test_torch_svds_targets.py`` and
``test_torch_svds_sm.py``, which import the helpers here.

Tolerances: each result is held to the bar ``tests/test_svds.py`` sets for
its fixture (singular values against numpy's SVD or the planted spectrum,
residuals, orthonormality), both packages' results alike; the solves'
matvecs (stage 1 plus stage 2) within ``MV_SLACK`` = 2x of the JAX
package's, as the other parity files hold them."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu
import primme_tpu_torch as ptt
from primme_tpu_torch import convert as CV

MV_SLACK = 2
# the module (the package's ``svds`` attribute is the function)
jsvds_mod = importlib.import_module("primme_tpu.svds")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # beside parallel test workers, extra intra-op threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rect():
    """``tests/test_svds.py``'s ``rect``: 200 x 150 with singular values
    linspace(1, 50)."""
    rng = np.random.default_rng(0)
    m, n = 200, 150
    U = np.linalg.qr(rng.normal(size=(m, n)))[0]
    V = np.linalg.qr(rng.normal(size=(n, n)))[0]
    sv = np.linspace(1, 50, n)[::-1]
    return U @ np.diag(sv) @ V.T, np.sort(sv)


def _both(A, jax_kw=None, **kw):
    """The port's svds on the CPU and the JAX package's, with ``kw`` (and
    ``jax_kw`` for the JAX call where an argument is the package's own
    object); each returns (U, s, Vt, stats)."""
    t = ptt.svds(A, device="cpu", return_stats=True, **kw)
    j = primme_tpu.svds(A, return_stats=True, **{**kw, **(jax_kw or {})})
    return t, j


def _mv(st, probe=True):
    total = st.get("stage1_num_matvecs", 0) + st.get("stage2_num_matvecs", 0)
    if not probe:
        total -= (st.get("stage1_num_probe_matvecs", 0)
                  + st.get("stage2_num_probe_matvecs", 0))
    return int(total)


def _mv_parity(t, j):
    mv, mvj = _mv(t[3]), _mv(j[3])
    assert mvj / MV_SLACK <= mv <= MV_SLACK * mvj, (mv, mvj)


@pytest.mark.parametrize("which", ["LM", "SM"])
def test_hybrid(rect, which):
    A, sv = rect
    t, j = _both(A, k=5, which=which, tol=1e-10)
    expect = sv[-5:] if which == "LM" else sv[:5]
    for U, s, Vt, _ in (t, j):
        assert np.abs(np.sort(s) - np.sort(expect)).max() < 1e-8 * sv[-1]
        R = A @ Vt.conj().T - U * s[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-7 * sv[-1]
        assert np.abs(U.T @ U - np.eye(5)).max() < 1e-8
        assert np.abs(Vt @ Vt.T - np.eye(5)).max() < 1e-8
    _mv_parity(t, j)
    # the reference's stage keys are all there
    assert set(j[3]) <= set(t[3])


@pytest.mark.parametrize("method", ["normalequations", "augmented"])
def test_single_stage(rect, method):
    A, sv = rect
    t, j = _both(A, k=4, which="LM", tol=1e-9, method=method)
    for _, s, _, st in (t, j):
        assert np.abs(np.sort(s) - sv[-4:]).max() < 1e-7 * sv[-1]
        # only the method's stage ran
        stage = "stage1" if method == "normalequations" else "stage2"
        assert {key.split("_")[0] for key in st} == {stage, "resnorms"}
    _mv_parity(t, j)


def test_wide_matrix():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(80, 120))  # m < n: the AAt path
    sref = np.linalg.svd(A, compute_uv=False)
    t, j = _both(A, k=5, which="LM", tol=1e-10)
    for _, s, _, _ in (t, j):
        assert np.abs(np.sort(s) - np.sort(sref)[-5:]).max() < 1e-8 * sref[0]
    _mv_parity(t, j)


def test_sparse_input():
    A = sp.random(300, 200, density=0.05, random_state=3)
    sref = np.linalg.svd(A.toarray(), compute_uv=False)
    t, j = _both(A, k=4, which="LM", tol=1e-9)
    for _, s, _, _ in (t, j):
        assert np.abs(np.sort(s) - np.sort(sref)[-4:]).max() < 1e-7
    _mv_parity(t, j)


# --- SvdsParams reflection ---------------------------------------------------

def _labelled(mod):
    sp_ = mod.SvdsParams(m=200, n=150)
    for label, value in (("numSvals", "3"), ("target", 2),
                         ("targetShifts", "20.5"), ("eps", "1e-9"),
                         ("method", "primme_svds_hybrid"),
                         ("methodStage2", "PRIMME_JDQMR"), ("iseed", 7),
                         ("primme.maxBasisSize", "20"),
                         ("primmeStage2.maxBlockSize", 2),
                         ("maxMatvecs", 40000)):
        sp_ = mod.svds_set_member(sp_, label, value)
    return sp_


def test_svds_params_reflection_matches_the_reference():
    sj, st = _labelled(jsvds_mod), _labelled(ptt)
    assert CV.svds_params_from_jax(sj) == st
    assert ptt.svds_member_names() == jsvds_mod.svds_member_names()
    assert ptt.svds_display_params(st) == jsvds_mod.svds_display_params(sj)
    for label in ("numSvals", "target", "targetShifts", "method_stage2",
                  "primme.maxBasisSize", "primmeStage2.maxBlockSize",
                  "primme.eps"):
        assert ptt.svds_get_member(st, label) == \
            jsvds_mod.svds_get_member(sj, label), label
    for label in ("aNorm", "primme.maxInnerIterations"):
        it, ij = ptt.svds_member_info(label), jsvds_mod.svds_member_info(label)
        assert (it["name"], it["default"]) == (ij["name"], ij["default"])
    for bad in (("target", 3), ("method", "lanczos"),
                ("methodStage2", "NOPE")):
        for mod in (ptt, jsvds_mod):
            with pytest.raises(ValueError):
                mod.svds_set_member(mod.SvdsParams(), *bad)
    for mod in (ptt, jsvds_mod):
        with pytest.raises(KeyError):
            mod.svds_set_member(mod.SvdsParams(), "primmeStage3.eps", 1)
        with pytest.raises(KeyError):
            mod.svds_set_member(mod.SvdsParams(), "nope", 1)


def test_svds_from_params_parity(rect):
    A, sv = rect
    sj = jsvds_mod.SvdsParams(m=200, n=150, num_svals=4, eps=1e-9,
                              locking=1, primme={"max_basis_size": 16})
    st = CV.svds_params_from_jax(sj)
    t = ptt.svds_from_params(A, st, device="cpu", return_stats=True)
    j = jsvds_mod.svds_from_params(A, sj, return_stats=True)
    for _, s, _, _ in (t, j):
        assert np.abs(np.sort(s) - sv[-4:]).max() < 1e-7 * sv[-1]
    _mv_parity(t, j)


# --- refusals ----------------------------------------------------------------

# the per-stage event stream (monitor, return_history) and segment_outer
# are served since the eleventh slice: their cases keep their places (and
# ids) and check the served call; mesh is served since the thirteenth
# slice, and its case checks that a value that is not a 1-D DeviceMesh is
# refused by name
SVDS_SERVED = ("monitor", "return_history", "segment_outer")


@pytest.mark.parametrize("kwargs", [
    {"monitor": print}, {"return_history": True}, {"mesh": "x"},
    {"segment_outer": 5}])
def test_svds_refuses_unported_arguments(rect, kwargs):
    name = next(iter(kwargs))
    if name in SVDS_SERVED:
        U, s, Vh, st = ptt.svds(rect[0], k=2, device="cpu",
                                return_stats=True, **kwargs)
        sv = np.linalg.svd(rect[0], compute_uv=False)[:2]
        assert np.abs(np.sort(s) - np.sort(sv)).max() <= 1e-8 * sv[0]
        if name == "return_history":
            assert len(st["hist"]["stage"]) > 0
        return
    with pytest.raises(TypeError, match="mesh must be a one-dimensional"):
        ptt.svds(rect[0], k=2, device="cpu", **kwargs)


def test_svds_refuses_complex_input():
    # complex input is served now (test_torch_complex.py holds it to the
    # JAX package): the dense and the sparse matrix give numpy's values;
    # half precision is served now too (test_torch_half_ops.py holds it to
    # the JAX package), to the half basis' floor
    A = np.ones((10, 6)) + 1j * np.eye(10, 6)
    sv = np.linalg.svd(A, compute_uv=False)
    for X in (A, sp.csr_matrix(A)):
        U, s, Vh = ptt.svds(X, k=2, tol=1e-10, device="cpu")
        assert U.dtype == Vh.dtype == np.complex128
        assert np.abs(np.sort(s)[::-1] - sv[:2]).max() < 1e-8 * sv[0]
    eps = float(np.finfo(np.float16).eps)
    sr = np.linalg.svd(A.real, compute_uv=False)
    U, s, Vh = ptt.svds(A.real.astype(np.float16), k=2, tol=4 * eps,
                        device="cpu")
    assert np.abs(np.sort(s)[::-1] - sr[:2]).max() < 16 * eps * sr[0]
