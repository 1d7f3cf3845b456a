"""The hand-written stencil and Jacobi kernels (csrc/stencil3d.cu,
csrc/jacobi.cu) against their plain PyTorch versions on the card. This file
imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_stencil_jacobi_cuda.py

Tolerance: none. Both kernels round once per operation in the plain
versions' order (no fma contraction, IEEE division), so they agree bit for
bit, NaN for NaN; every test here needs a card and skips without one."""

import pytest
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST

GRIDS = [(1, 1, 1), (3, 5, 7), (16, 16, 16)]
TYPES = [torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    torch.cuda.synchronize()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("grid", GRIDS)
def test_stencil_kernel_matches_plain(card, grid, dtype):
    n = grid[0] * grid[1] * grid[2]
    for k in (1, 2, 13):
        for scale in (1.0, 0.1):
            X = torch.randn((n, k), dtype=dtype, device=card)
            before = dict(ST.KERNEL_LAUNCHES)
            y = ST.matmat(X, *grid, scale)
            entry = "stencil3d_f32" if dtype == torch.float32 \
                else "stencil3d_f64"
            assert ST.KERNEL_LAUNCHES == {**before,
                                          entry: before[entry] + 1}
            assert _same(y, ST.matmat_reference(X, *grid, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
def test_stencil_kernel_column_slice_and_nonfinite(card, dtype):
    grid = (3, 5, 7)
    W = torch.randn((105, 17), dtype=dtype, device=card)
    W[52, 3], W[0, 5], W[104, 4] = float("nan"), float("inf"), -float("inf")
    X = W[:, 3:16]                              # k = 13, rows 17 apart
    assert X.stride() == (17, 1)
    y = ST.matmat(X, *grid, 0.5)
    assert _same(y, ST.matmat_reference(X.contiguous(), *grid, 0.5))
    assert _same(ST.matmat(W[:, 3:4], *grid), ST.matmat_reference(
        W[:, 3:4].contiguous(), *grid))
    with pytest.raises(ValueError, match="adjacent"):
        ST.matmat(W.t().contiguous().t(), *grid)
    with pytest.raises(TypeError, match="dtype"):
        ST.matmat(W.to(torch.float16), *grid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("n", [1, 105, 4096])
def test_jacobi_kernels_match_plain(card, n, dtype):
    for k in (1, 13):
        d = torch.empty(n, dtype=dtype, device=card).uniform_(-3.0, 5.0)
        X = torch.randn((n, k), dtype=dtype, device=card)
        s = torch.linspace(-2.0, 4.0, k, dtype=dtype, device=card)
        s[0] = d[n // 2]                        # the eps clamp fires
        for eps in (1e-10, 0.5):
            suffix = "f32" if dtype == torch.float32 else "f64"
            before = dict(JK.KERNEL_LAUNCHES)
            y = JK.shifted(X, d, s, eps)
            z = JK.unshifted(X, d, eps)
            assert JK.KERNEL_LAUNCHES == {
                **before,
                "jacobi_shifted_" + suffix:
                    before["jacobi_shifted_" + suffix] + 1,
                "jacobi_" + suffix: before["jacobi_" + suffix] + 1}
            assert _same(y, JK.shifted_reference(X, d, s, eps))
            assert _same(z, JK.unshifted_reference(X, d, eps))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
def test_jacobi_kernels_column_slice_and_nonfinite(card, dtype):
    n = 105
    d = torch.empty(n, dtype=dtype, device=card).uniform_(1.0, 5.0)
    d[7], d[9] = float("nan"), 0.0
    W = torch.randn((n, 20), dtype=dtype, device=card)
    W[3, 2], W[4, 5] = float("nan"), float("inf")
    X = W[:, 2:15]
    s = torch.randn(13, dtype=dtype, device=card)
    s[4] = float("nan")
    assert _same(JK.shifted(X, d, s, 1e-10),
                 JK.shifted_reference(X.contiguous(), d, s, 1e-10))
    assert _same(JK.unshifted(X, d, 1e-10),
                 JK.unshifted_reference(X.contiguous(), d, 1e-10))
    with pytest.raises(ValueError, match="sigma"):
        JK.shifted(X, d, s[:3], 1e-10)
    with pytest.raises(TypeError, match="dtype"):
        JK.shifted(X, d.to(torch.float16), s, 1e-10)
    with pytest.raises(ValueError, match="on"):
        JK.unshifted(X, d.cpu(), 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
def test_jacobi_over_dense_diagonal(card, dtype):
    # a DenseOperator's diagonal is a strided view of its matrix
    A = torch.randn((50, 50), dtype=dtype, device=card) + 4 * torch.eye(
        50, dtype=dtype, device=card)
    K = ptt.JacobiPrecond(ptt.DenseOperator(A).diagonal())
    X = torch.randn((50, 3), dtype=dtype, device=card)
    s = torch.tensor([0.0, 1.0, -2.0], dtype=dtype, device=card)
    d = torch.diagonal(A).contiguous()
    assert _same(K.matmat_shifted(X, s), JK.shifted_reference(X, d, s, 1e-10))
    assert _same(K.matmat(X), JK.unshifted_reference(X, d, 1e-10))
