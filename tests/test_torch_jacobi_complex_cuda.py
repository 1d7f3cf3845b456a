"""The complex entry points of ``csrc/jacobi.cu`` (``jacobi_shifted_c64``,
``jacobi_shifted_c128``, ``jacobi_c64``, ``jacobi_c128``) on the card
against their plain versions, and the twelfth slice's solves on the card
against the same calls on the CPU. This file imports no jax, so that it
runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_jacobi_complex_cuda.py

Tolerances: none for the kernels (each operation rounded once, in the
plain version's order: bit for bit, NaN for NaN); solves: values within
their tolerance of the closed form on the card and on the CPU, the card's
matvecs within 2x of the CPU's. Every test here needs a card and skips
without one."""

import numpy as np
import pytest
import torch

import chip_smoke as CS
import primme_tpu_torch as ptt
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST
from primme_tpu_torch.ops import windowed_ell as WE

MODS = (DK, WE, ST, JK)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _bitwise(a, b):
    a, b = torch.view_as_real(a), torch.view_as_real(b)
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _inputs(n, k, dtype, dev, real_den, off=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    if off is None:
        X = torch.randn((n, k), generator=g, dtype=dtype, device=dev)
    else:
        X = torch.randn((n, 24), generator=g, dtype=dtype,
                        device=dev)[:, off:off + k]
    dre = torch.rand(n, generator=g, dtype=rdt, device=dev) * 8 - 3
    sre = torch.rand(k, generator=g, dtype=rdt, device=dev)
    dim = (torch.zeros_like(dre) if real_den
           else torch.randn(n, generator=g, dtype=rdt, device=dev))
    sim = (torch.zeros_like(sre) if real_den
           else torch.randn(k, generator=g, dtype=rdt, device=dev))
    d, s = torch.complex(dre, dim), torch.complex(sre, sim)
    d[n // 3] = 0
    s[0] = d[n // 2]
    return X, d, s


@pytest.mark.cuda
@pytest.mark.parametrize("real_den", [True, False])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("n,k,off", [(1, 1, None), (1000, 1, None),
                                     (4097, 2, None), (4097, 3, None),
                                     (70000, 8, None), (5000, 13, None),
                                     (3001, 2, 1), (3001, 5, 3)])
def test_complex_kernels_bit_for_bit(card, dtype, real_den, n, k, off):
    X, d, s = _inputs(n, k, dtype, card, real_den, off)
    X[n // 4, 0] = complex(float("nan"), 1.0)
    for eps in (1e-10, 0.5):
        for kern, plain, name in (
                (lambda: JK.shifted(X, d, s, eps),
                 lambda: JK.shifted_reference(X, d, s, eps),
                 "jacobi_shifted_"),
                (lambda: JK.unshifted(X, d, eps),
                 lambda: JK.unshifted_reference(X, d, eps), "jacobi_")):
            entry = name + ("c64" if dtype == torch.complex64 else "c128")
            before = JK.KERNEL_LAUNCHES[entry]
            y = kern()
            assert JK.KERNEL_LAUNCHES[entry] == before + 1
            yref = plain()
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.is_contiguous()
            assert _bitwise(y, yref), (entry, n, k, off, eps)


@pytest.mark.cuda
def test_complex_wrapper_refuses(card):
    X, d, s = _inputs(100, 2, torch.complex64, card, False)
    with pytest.raises(TypeError):
        JK.shifted(X, d.to(torch.complex128), s, 1e-10)
    with pytest.raises(ValueError):
        JK.shifted(X, d, s[:1], 1e-10)
    with pytest.raises(ValueError):
        JK.shifted(X.t().contiguous().t(), d, s, 1e-10)  # column-major


@pytest.mark.cuda
def test_jacobi_precond_complex_routes(card):
    """A complex diagonal runs the complex entry points; a real diagonal
    given complex shifts runs the complex shifted entry point on the
    promoted diagonal, and given real shifts the real one on the block's
    real view."""
    X, d, s = _inputs(2000, 2, torch.complex128, card, False)
    CS.reset_counts(JK)
    ptt.JacobiPrecond(d).matmat_shifted(X, s)
    ptt.JacobiPrecond(d).matmat(X)
    dr = d.real.contiguous()
    ptt.JacobiPrecond(dr).matmat_shifted(X, s)
    ptt.JacobiPrecond(dr).matmat_shifted(X, s.real.contiguous())
    assert JK.KERNEL_LAUNCHES["jacobi_shifted_c128"] == 2
    assert JK.KERNEL_LAUNCHES["jacobi_c128"] == 1
    assert JK.KERNEL_LAUNCHES["jacobi_shifted_f64"] == 1
    # the card's apply against the CPU's
    y = ptt.JacobiPrecond(dr).matmat_shifted(X, s).cpu()
    yc = ptt.JacobiPrecond(dr.cpu()).matmat_shifted(X.cpu(), s.cpu())
    assert torch.allclose(y, yc, rtol=1e-14, atol=0)


@pytest.mark.cuda
def test_complex_hermitian_jacobi_solve_on_the_card(card):
    """``eigsh(jacobi=True)`` on the 16^3 magnetic Laplacian in complex64
    (n = 4096: a dense operator; the complex shifted Jacobi on the card)
    against the same call on the CPU."""
    L, ev, anorm = CS.magnetic_laplacian(16, dtype="complex64")
    kw = dict(k=6, which="SA", tol=1e-5, jacobi=True, return_stats=True)
    CS.reset_counts(*MODS)
    w, V, st = ptt.eigsh(L, device=card, **kw)
    assert JK.KERNEL_LAUNCHES["jacobi_shifted_c64"] > 0
    wc, _, sc = ptt.eigsh(L, device="cpu", **kw)
    for vals in (w, wc):
        assert np.abs(np.sort(vals) - ev[:6]).max() <= 1e-4
    assert st["num_matvecs"] <= 2 * sc["num_matvecs"]


@pytest.mark.cuda
@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_half_basis_on_the_card(card, half):
    """The half basis on the permuted 16^3 27-point Laplacian (the
    windowed f32 kernel for every product) against the same call on the
    CPU: the reference test's floor on both."""
    A, ev = CS.laplacian27(16, 0)
    eps = float(torch.finfo(half).eps)
    kw = dict(k=4, which="SA", tol=4 * eps, dtype=half, return_stats=True,
              raise_for_unconverged=False)
    CS.reset_counts(*MODS)
    w, X, st = ptt.eigsh(A, device=card, **kw)
    assert WE.KERNEL_LAUNCHES["windowed_ell_spmm_f32"] >= st["num_matvecs"] / 2
    wc, Xc, sc = ptt.eigsh(A, device="cpu", **kw)
    anorm = float(np.abs(ev).max())
    for vals, vecs in ((w, X), (wc, Xc)):
        assert vals.dtype == vecs.dtype == np.float32
        R = A.astype(np.float64) @ vecs - vecs * vals[None, :]
        assert np.linalg.norm(R, axis=0).max() < 16 * eps * anorm
    assert st["num_matvecs"] <= 2 * sc["num_matvecs"]
