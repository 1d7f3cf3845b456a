"""The complex entry points of the hand-written kernels on the card: DIA's
``dia_c64``/``dia_c128`` (csrc/dia.cu) and the sliced ELL's
``windowed_ell_spmm_c64``/``_c128`` (csrc/windowed_ell.cu) against their
plain PyTorch versions; the complex operators and a real operator's
product of a complex block on the card against the same operators on the
CPU; ``eigsh`` and ``svds`` on complex input on the card against the CPU.
This file imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_complex_cuda.py

Tolerances: none for DIA. Its complex product is ``(vr xr - vi xi, vr xi
+ vi xr)`` rounded once per operation in the plain version's order (no
fma), so the two agree bit for bit, NaN for NaN, in both modes, on the
vector and the scalar path. The sliced ELL sums with fma in slot order,
so it is held to 1e-5 (complex64) and 1e-13 (complex128) of max|y|, as
its real entry points are; so are the operators and the real operator's
complex product. Solves on the card and on the CPU take different rounding
paths: their eigenvalues agree to 1e-4 (complex64, tol 1e-5) and 1e-8
(complex128, tol 1e-10). Every test here needs a card and skips without
one."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke as CS
import primme_tpu_torch as ptt
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import windowed_ell as WE

CTYPES = [torch.complex64, torch.complex128]
ENTRY = {torch.complex64: "c64", torch.complex128: "c128"}
WIDTHS = (1, 2, 3, 4, 8, 13)
REL = {torch.complex64: 1e-5, torch.complex128: 1e-13,
       torch.float32: 1e-5, torch.float64: 1e-13}
# (n, offsets in stored order): a tridiagonal, unsorted offsets past n/2,
# the magnetic Laplacian's 11 at N = 8, a size past one block of 256 rows
CASES = [(300, (-1, 0, 1)), (300, (5, -3, 0, 151, -170, 299, -299)),
         (512, (0, 1, -1, 8, -8, 56, -56, 64, -64, 448, -448)),
         (70001, (0, 1, -1, 4096, -4096, 64, -64))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _crandn(shape, dtype, device):
    return torch.randn(shape, dtype=dtype, device=device)


def _same(a, b):
    torch.cuda.synchronize()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _blocks(n, k, dtype, card):
    """Column blocks of width k: contiguous, and slices of a 24-wide block
    at an even and an odd column offset."""
    W = _crandn((n, 24), dtype, card)
    out = [_crandn((n, k), dtype, card)]
    for off in (2, 1):
        if off + k <= 24:
            out.append(W[:, off:off + k])
    return out


def _close(y, ref, dtype):
    torch.cuda.synchronize()
    return float((y.cpu() - ref.cpu()).abs().max()) \
        <= REL[dtype] * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CTYPES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dia_complex_kernel_matches_plain(card, case, dtype):
    n, offs = CASES[case]
    vals = _crandn((len(offs), n), dtype, card)
    dev_offs = torch.tensor(offs, dtype=torch.int64, device=card)
    entry = "dia_" + ENTRY[dtype]
    for k in WIDTHS:
        for X in _blocks(n, k, dtype, card):
            for adjoint, plain in ((False, DK.matmat_reference),
                                   (True, DK.rmatmat_reference)):
                before = dict(DK.KERNEL_LAUNCHES)
                y = DK.matmat(vals, dev_offs, X, adjoint=adjoint)
                assert DK.KERNEL_LAUNCHES == {**before,
                                              entry: before[entry] + 1}
                assert _same(y, plain(vals, offs, X)), (k, adjoint)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CTYPES)
def test_dia_complex_nan_inf_and_signed_zero(card, dtype):
    # off-edge terms are v * 0 (NaN parts for an Inf or NaN v) in matmat
    # and 0 * 0 in rmatmat; signed zeros as the plain version's
    n, offs = 257, (3, 0, -2)
    vals = _crandn((3, n), dtype, card)
    vals[0, -1] = complex(float("inf"), 1.0)
    vals[2, 0] = complex(0.0, float("nan"))
    vals[1, 10] = complex(-0.0, -0.0)
    X = _crandn((n, 2), dtype, card)
    X[10] = complex(-0.0, 0.0)
    X[50, 1] = complex(1.0, float("inf"))
    for adjoint, plain in ((False, DK.matmat_reference),
                           (True, DK.rmatmat_reference)):
        y = DK.matmat(vals, torch.tensor(offs, device=card), X,
                      adjoint=adjoint)
        ref = plain(vals, offs, X)
        assert _same(y, ref)
        assert torch.equal(torch.signbit(torch.view_as_real(y)),
                           torch.signbit(torch.view_as_real(ref)))


@pytest.mark.cuda
def test_dia_complex_wrapper_refuses(card):
    vals = _crandn((2, 64), torch.complex64, card)
    X = _crandn((64, 2), torch.complex64, card)
    offs = torch.tensor((0, 1), device=card)
    with pytest.raises(TypeError, match="X has dtype"):
        DK.matmat(vals, offs, X.to(torch.complex128))
    with pytest.raises(TypeError, match="X has dtype"):
        DK.matmat(vals, offs, X.real.contiguous())
    with pytest.raises(TypeError, match="complex64 or complex128"):
        DK.matmat(vals.real.to(torch.int32), offs, X.real.to(torch.int32))


def _random_complex_csr(m, n, density, seed, dtype):
    A = sp.random(m, n, density=density, random_state=seed, format="csr")
    B = sp.random(m, n, density=density, random_state=seed + 1, format="csr")
    return (A + 1j * B).astype(dtype)


def _layouts(dtype):
    """Square and rectangular CSR matrices with empty rows and slices, and
    the magnetic incidence at N = 8 with 0.1 I under it (svds' A)."""
    npdt = np.dtype(str(dtype).replace("torch.", ""))
    E = _random_complex_csr(3000, 3000, 2e-3, 0, npdt).tolil()
    E[100:400] = 0
    A = CS.magnetic_svd_matrix(8)[0].astype(npdt)
    return {"square": E.tocsr(),
            "rect": _random_complex_csr(2000, 777, 4e-3, 3, npdt),
            "svd A": A, "svd A^H": A.conj().T.tocsr()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CTYPES)
def test_sliced_ell_complex_kernel_matches_plain(card, dtype):
    npdt = np.dtype(str(dtype).replace("torch.", ""))
    entry = "windowed_ell_spmm_" + ENTRY[dtype]
    for name, A in _layouts(dtype).items():
        lay = WE.from_csr(A, npdt)
        arrays = [torch.as_tensor(getattr(lay, f)).to(card)
                  for f in WE.SlicedELL._fields]
        for k in WIDTHS:
            X = _crandn((A.shape[1], k), dtype, card)
            before = dict(WE.KERNEL_LAUNCHES)
            y = WE.matmat(*arrays, X, A.shape[1])
            assert WE.KERNEL_LAUNCHES[entry] > before[entry], (name, k)
            ref = WE.matmat_reference(*arrays, X, A.shape[1])
            assert _close(y, ref, dtype), (name, k)
            yh = (A.astype(np.complex128) @ X.cpu().numpy().astype(
                np.complex128))
            assert np.abs(y.cpu().numpy() - yh).max() \
                <= 10 * REL[dtype] * np.abs(yh).max(), (name, k)


def _path_layouts(npdt):
    """A narrow layout (the magnetic incidence at N = 8 with 0.1 I under
    it: rows of 1-2 entries) and a wide one (the 27-point Laplacian at 8^3
    in a random order, 27 a row inside), complex ones given random phases,
    each with the path the wrapper's rule gives it."""
    rng = np.random.default_rng(4)
    A = CS.magnetic_svd_matrix(8)[0]
    L = CS.laplacian27(8, 0)[0].astype(np.float64).tocoo()
    if np.iscomplexobj(np.zeros(1, npdt)):
        L = sp.coo_matrix((L.data * np.exp(2j * np.pi * rng.random(L.nnz)),
                           (L.row, L.col)), shape=L.shape)
    else:
        A = A.real
    return {"narrow": (A.astype(npdt).tocsr(), "direct"),
            "wide": (L.astype(npdt).tocsr(), "ring")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CTYPES + [torch.float32, torch.float64])
def test_sliced_ell_paths_agree(card, dtype):
    """Both paths of the sliced-ELL kernel, forced through the wrapper, on
    a narrow and a wide layout: bit for bit with each other (the same
    consumer loop, the same slot order) and within the type's bar of the
    plain version; the wrapper's own choice is the layout's rule."""
    npdt = np.dtype(str(dtype).replace("torch.", ""))
    entry = WE._ENTRY[dtype]
    for name, (A, path) in _path_layouts(npdt).items():
        lay = WE.from_csr(A, npdt)
        arrays = [torch.as_tensor(getattr(lay, f)).to(card)
                  for f in WE.SlicedELL._fields]
        assert WE.choose_path(arrays[0], arrays[2]) == path, name
        for k in WIDTHS:
            X = torch.randn((A.shape[1], k), dtype=dtype, device=card)
            ys = {}
            for p in WE.PATHS:
                before = WE.KERNEL_LAUNCHES[entry], WE.DIRECT_LAUNCHES[entry]
                ys[p] = WE.matmat(*arrays, X, A.shape[1], path=p)
                assert WE.KERNEL_LAUNCHES[entry] == before[0] + 1
                assert WE.DIRECT_LAUNCHES[entry] == before[1] + (
                    p == "direct")
            before = WE.DIRECT_LAUNCHES[entry]
            y = WE.matmat(*arrays, X, A.shape[1])
            assert WE.DIRECT_LAUNCHES[entry] == before + (path == "direct")
            assert _same(ys["ring"], ys["direct"]), (name, k)
            assert _same(y, ys[path]), (name, k)
            ref = WE.matmat_reference(*arrays, X, A.shape[1])
            assert _close(y, ref, dtype), (name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_formats_on_the_card(card, dtype):
    # the chooser's banded operator (the magnetic Laplacian), a complex
    # hybrid and an ELLOperator, matmat and rmatmat (A^H) on the card
    # against the same operators on the CPU
    rng = np.random.default_rng(0)
    L = CS.magnetic_laplacian(10, dtype=dtype)[0]
    n = L.shape[0]
    S = _random_complex_csr(n, n, 1e-4, 5, dtype)
    mats = {"banded": L, "hybrid": (L + S + S.conj().T).tocsr(),
            "ell": _random_complex_csr(n, n, 2e-3, 7, dtype)}
    kinds = {"banded": ptt.BandedOperator, "hybrid": ptt.SumOperator,
             "ell": ptt.ELLOperator}
    for name, A in mats.items():
        op = (ptt.ELLOperator.from_scipy(A) if name == "ell"
              else ptt.rcm_banded(A)[0])
        assert isinstance(op, kinds[name]) and op.dtype == getattr(
            torch, np.dtype(dtype).name), name
        X = torch.as_tensor((rng.normal(size=(n, 3))
                             + 1j * rng.normal(size=(n, 3))).astype(dtype))
        cpu = op.matmat(X), op.rmatmat(X)
        op = op.to(card)
        d0 = dict(DK.KERNEL_LAUNCHES), dict(WE.KERNEL_LAUNCHES)
        gpu = op.matmat(X.to(card)), op.rmatmat(X.to(card))
        launched = (DK.KERNEL_LAUNCHES != d0[0], WE.KERNEL_LAUNCHES != d0[1])
        assert launched == {"banded": (True, False), "hybrid": (True, True),
                            "ell": (False, True)}[name], name
        for c, g in zip(cpu, gpu):
            assert _close(g, c, X.dtype), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_real_operators_on_complex_blocks_on_the_card(card, dtype):
    # a real operator's product of a complex block is that of both parts,
    # one launch of the real entry point on the [n, 2k] view
    rng = np.random.default_rng(1)
    npdt = np.dtype(str(dtype).replace("torch.", ""))
    T = sp.diags([np.full(999, -1.), np.arange(1., 1001.), np.full(999, -1.)],
                 [-1, 0, 1]).tocsr().astype(npdt)
    ops = {"banded": ptt.BandedOperator.from_scipy(T),
           "ell": ptt.ELLOperator.from_scipy(T),
           "stencil": ptt.Stencil3DOperator(10, 10, 10, dtype=dtype,
                                            device="cpu"),
           "jacobi": ptt.JacobiPrecond(torch.arange(1., 1001., dtype=dtype))}
    X = torch.as_tensor(rng.normal(size=(1000, 3))
                        + 1j * rng.normal(size=(1000, 3)))
    for name, op in ops.items():
        cpu = op.matmat(X)
        parts = torch.complex(op.matmat(X.real), op.matmat(X.imag))
        assert _close(cpu, parts, dtype), name
        gpu = op.to(card).matmat(X.to(card))
        assert gpu.is_complex() and _close(gpu, cpu, dtype), name
    jac = ops["jacobi"]
    sh = torch.tensor([0.5, 2.5, -1.0], dtype=dtype)
    assert _close(jac.matmat_shifted(X.to(card), sh.to(card)),
                  jac.to("cpu").matmat_shifted(X, sh), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.complex64, 1e-5),
                                       (np.complex128, 1e-10)])
def test_complex_eigsh_and_svds_on_the_card(card, dtype, tol):
    L, ev, anorm = CS.magnetic_laplacian(10, dtype=dtype)
    name = "dia_" + ("c64" if dtype == np.complex64 else "c128")
    before = DK.KERNEL_LAUNCHES[name]
    w, V, st = ptt.eigsh(L, tol=tol, seed=0, device="cuda",
                         **CS.SOLVE_KWARGS)
    assert DK.KERNEL_LAUNCHES[name] - before >= st["num_matvecs"] / 2
    bar = 1e-4 if dtype == np.complex64 else 1e-8
    assert np.abs(np.sort(w) - ev[:10]).max() <= bar
    R = L.astype(np.complex128) @ V.astype(np.complex128) - V * w[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 1.5 * tol * anorm
    A, sv = CS.magnetic_svd_matrix(8)
    A = A.astype(dtype)
    U, s, Vh = ptt.svds(A, k=4, which="SM", tol=max(tol, 1e-8),
                        device="cuda")
    assert np.abs(np.sort(s) - sv[:4]).max() <= 10 * max(tol, 1e-8) * sv[-1]
    assert np.abs(U.conj().T @ U - np.eye(4)).max() <= 1e-4
