"""``svds`` and the sliced-ELL kernel on rectangular layouts, on the card:
the kernel against its plain version on the ``A`` and ``A^T`` layouts of
rectangular matrices, and the ``tests/test_torch_svds.py`` fixtures solved
on the card against the same calls on the CPU. This file imports no jax,
so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_svds_cuda.py

Tolerances: the kernel sums each row in the plain version's order, with
fma on the card: 1e-5 (f32) and 1e-13 (f64) of max|y|, as
``chip_smoke.py``'s phases 3/5; each solve at its fixture's bar against
numpy's SVD or the closed form (as ``tests/test_svds.py`` sets it), its
values within the same bar of the CPU run's and its matvecs within 2x of
the CPU run's (the card's products and reductions round otherwise, so the
iterations differ). Every test here needs a card and skips without one."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch.ops import windowed_ell as WE
from chip_smoke import grounded_incidence


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rect(m, n, seed):
    """Empty rows (a whole slice), empty columns, a long row."""
    A = sp.random(m, n, density=0.05, random_state=seed, format="lil")
    A[32:64, :] = 0
    A[:, 3:9] = 0
    A[5, :] = np.random.default_rng(seed).normal(size=n)
    return A.tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(np.float32, 1e-5),
                                       (np.float64, 1e-13)])
@pytest.mark.parametrize("shape", [(3001, 257), (257, 3001)])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 13])
def test_kernel_on_rectangular_layouts(card, shape, k, dtype, rel):
    A = _rect(*shape, seed=k).astype(dtype)
    tdt = getattr(torch, np.dtype(dtype).name)
    gen = torch.Generator().manual_seed(k)
    for M in (A, A.T.tocsr()):
        lay = WE.from_csr(M, dtype)
        arrays = [torch.as_tensor(a).to(card) for a in lay]
        X = torch.randn((M.shape[1], k), generator=gen, dtype=tdt)
        WE.LAUNCHES = 0
        y = WE.matmat(*arrays, X.to(card), M.shape[1])
        assert WE.LAUNCHES == 1 and y.shape == (M.shape[0], k)
        yref = WE.matmat_reference(*(a.cpu() for a in arrays), X,
                                   M.shape[1])
        ymax = float(yref.abs().max())
        assert float((y.cpu() - yref).abs().max()) <= rel * ymax
        with pytest.raises(ValueError, match="is not"):
            WE.matmat(*arrays, X[:-1].to(card), M.shape[1])


@pytest.mark.cuda
def test_kernel_on_the_augmented_block(card):
    """The augmented operator's tall [m + n, k] blocks at the smoke's
    rows: ``rmatmat`` on the lower m rows and ``matmat`` on the upper n
    rows, both from column slices of one block."""
    A, _ = grounded_incidence(40)
    m, n = A.shape
    op = ptt.ELLOperator.from_scipy(A)
    X = torch.randn((m + n, 4), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    top = ptt.ELLOperator.from_scipy(A).to(card)   # .to moves in place
    for fn, part in (("rmatmat", X[n:]), ("matmat", X[:n])):
        y = getattr(top, fn)(part.to(card)).cpu()
        yref = getattr(op, fn)(part)
        assert float((y - yref).abs().max()) <= 1e-13 * float(
            yref.abs().max()), fn


def _solve(A, dev, **kw):
    WE.LAUNCHES = 0
    U, s, Vt, st = ptt.svds(A, device=dev, return_stats=True, **kw)
    mv = st.get("stage1_num_matvecs", 0) + st.get("stage2_num_matvecs", 0)
    return U, s, Vt, mv, WE.LAUNCHES


def _rect_fixture():
    rng = np.random.default_rng(0)
    m, n = 200, 150
    U = np.linalg.qr(rng.normal(size=(m, n)))[0]
    V = np.linalg.qr(rng.normal(size=(n, n)))[0]
    sv = np.linspace(1, 50, n)[::-1]
    return U @ np.diag(sv) @ V.T, np.sort(sv)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["LM", "SM"])
def test_hybrid_on_the_card(card, which):
    A, sv = _rect_fixture()
    expect = sv[-5:] if which == "LM" else sv[:5]
    runs = [_solve(A, d, k=5, which=which, tol=1e-10) for d in ("cpu", card)]
    for U, s, Vt, _, _ in runs:
        assert np.abs(np.sort(s) - np.sort(expect)).max() < 1e-8 * sv[-1]
        R = A @ Vt.T - U * s[None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-7 * sv[-1]
        assert np.abs(U.T @ U - np.eye(5)).max() < 1e-8
    (_, sc, _, mvc, _), (_, sg, _, mvg, _) = runs
    assert np.abs(np.sort(sg) - np.sort(sc)).max() < 1e-8 * sv[-1]
    assert mvc / 2 <= mvg <= 2 * mvc


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lm", "sm", "augmented_f32"])
def test_incidence_on_the_card(card, case):
    """The grounded incidence at N = 21 (an ELLOperator): every product on
    the card runs the sliced-ELL kernel (two launches a normal-equations
    matvec, two an augmented one, plus the true residuals)."""
    kw, dtype, bar = {
        "lm": (dict(k=4, which="LM", tol=1e-8), "float64", 1e-8),
        "sm": (dict(k=4, which="SM", tol=1e-8), "float64", 1e-7),
        "augmented_f32": (dict(k=4, which="LM", tol=1e-5,
                               method="augmented"), "float32", 1e-4)}[case]
    A, sv = grounded_incidence(21, dtype=dtype)
    ref = sv[-4:] if kw["which"] == "LM" else sv[:4]
    runs = [_solve(A, d, **kw) for d in ("cpu", card)]
    A64 = A.astype(np.float64)
    for U, s, Vt, _, _ in runs:
        assert np.abs(np.sort(s) - ref).max() <= bar * sv[-1]
        U, Vt = U.astype(np.float64), Vt.astype(np.float64)
        R1 = A64 @ Vt.T - U * s[None, :]
        R2 = A64.T @ U - Vt.T * s[None, :]
        res = np.sqrt((R1 ** 2).sum(axis=0) + (R2 ** 2).sum(axis=0))
        assert res.max() <= 10 * kw["tol"] * sv[-1]
    (_, sc, _, mvc, _), (_, sg, _, mvg, launches) = runs
    assert mvc / 2 <= mvg <= 2 * mvc
    assert launches >= mvg


@pytest.mark.cuda
def test_svds_default_device_is_the_card(card):
    A, sv = _rect_fixture()
    s = ptt.svds(sp.csr_matrix(A), k=3, tol=1e-9,
                 return_singular_vectors=False)
    assert np.abs(np.sort(s) - sv[-3:]).max() < 1e-7 * sv[-1]
