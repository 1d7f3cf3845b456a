"""The hand-written stencil and Jacobi kernels (csrc/stencil3d.cu,
csrc/jacobi.cu) against their plain PyTorch versions on the card. This file
imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_stencil_jacobi_cuda.py

Tolerance: none. Both kernels round once per operation in the plain
versions' order (no fma contraction, IEEE division), so they agree bit for
bit, NaN for NaN, on the vector path (X loaded 8 or 16 bytes at a time) and
on the scalar one (a column slice at an odd offset); every test here needs
a card and skips without one."""

import pytest
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST

GRIDS = [(1, 1, 1), (3, 5, 7), (16, 16, 16), (17, 33, 65)]
WIDTHS = (1, 2, 3, 4, 8, 13)
TYPES = [torch.float32, torch.float64]
LARGE = (160, 160, 160)    # 20 j tiles, 160 planes of column groups


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


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def _blocks(n, k, dtype, card):
    """Column blocks of width k: contiguous, and slices of a 24-wide block
    at an even and an odd column offset. The wide block's rows are 24
    elements apart and its base 16-byte aligned, so X loads in vectors
    exactly when k and the offset are even."""
    W = torch.randn((n, 24), dtype=dtype, device=card)
    out = [(torch.randn((n, k), dtype=dtype, device=card), k % 2 == 0)]
    for off in (2, 1):
        if off + k <= 24:
            out.append((W[:, off:off + k], k % 2 == 0 and off % 2 == 0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("grid", GRIDS)
def test_stencil_kernel_matches_plain(card, grid, dtype):
    n = grid[0] * grid[1] * grid[2]
    entry = "stencil3d_" + _suffix(dtype)
    for k in WIDTHS:
        for X, vector in _blocks(n, k, dtype, card):
            for scale in (1.0, 0.1):
                before = dict(ST.KERNEL_LAUNCHES)
                vec_before = ST.VECTOR_LAUNCHES[entry]
                y = ST.matmat(X, *grid, scale)
                assert ST.KERNEL_LAUNCHES == {**before,
                                              entry: before[entry] + 1}
                assert ST.VECTOR_LAUNCHES[entry] == vec_before + vector
                assert _same(y, ST.matmat_reference(X.contiguous(), *grid,
                                                    scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
def test_stencil_kernel_on_a_large_grid(card, dtype):
    # thousands of blocks, contiguous blocks and slices, every column group
    n = LARGE[0] * LARGE[1] * LARGE[2]
    for k in (2, 8):
        for X, _ in _blocks(n, k, dtype, card):
            ref = ST.matmat_reference(X.contiguous(), *LARGE, 0.5)
            assert ST.card_plan(X, *LARGE).grid[1:] == (20, 160 * (
                k // ST.column_group(k)))
            assert _same(ST.matmat(X, *LARGE, 0.5), ref)
            for p in _plans(X, LARGE):
                assert _same(_launch(X, LARGE, p, 0.5), ref), (k, p)


def _plans(X, grid):
    """Plans of X on the grid, one for every column group (one thread a
    point, or threads sharing a wide one)."""
    k, size = X.shape[1], X.element_size()
    ldx, align = X.stride(0), X.data_ptr() % 16
    return [ST.plan(*grid, k, ldx, align, size, kc)
            for kc in (c for c in (1, 2, 4, 8) if k % c == 0)]


def _launch(X, grid, p, scale=1.0):
    """The stencil kernel on X under plan p, whatever the wrapper picks."""
    Y = torch.empty((X.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    ST.launch(X, Y, *grid, scale, p)
    return Y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
def test_stencil_kernel_split_launches(card, dtype):
    # grids past CUDA's 65535 planes (with column groups) or j tiles run as
    # several launches from offsets; one call counts one launch
    for grid, k in (((70000, 1, 32), 1), ((5042, 2, 3), 13),
                    ((1, 8 * 65535 + 1, 1), 1)):
        n = grid[0] * grid[1] * grid[2]
        X = torch.randn((n, k), dtype=dtype, device=card)
        assert len(ST.card_plan(X, *grid).launches) == 2
        before = ST.LAUNCHES
        y = ST.matmat(X, *grid, 0.5)
        assert ST.LAUNCHES == before + 1
        assert _same(y, ST.matmat_reference(X, *grid, 0.5)), grid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("grid", GRIDS)
def test_stencil_every_plan_on_small_grids(card, grid, dtype):
    # every column group, whatever the wrapper would pick: the edges are
    # a tile past the grid's edge and a point shared by threads
    n = grid[0] * grid[1] * grid[2]
    for k in WIDTHS:
        for X, _ in _blocks(n, k, dtype, card):
            ref = ST.matmat_reference(X.contiguous(), *grid, 0.5)
            for p in _plans(X, grid):
                assert _same(_launch(X, grid, p, 0.5), ref), (k, p)


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
    for p in _plans(X, grid):       # every plan sees the same
        assert _same(_launch(X, grid, p, 0.5), y), p
    assert _same(ST.matmat(W[:, 3:4], *grid), ST.matmat_reference(
        W[:, 3:4].contiguous(), *grid))
    for off in (2, 3):                          # k = 2: vector and scalar
        assert _same(ST.matmat(W[:, off:off + 2], *grid), ST.matmat_reference(
            W[:, off:off + 2].contiguous(), *grid))
    with pytest.raises(ValueError, match="adjacent"):
        ST.matmat(W.t().contiguous().t(), *grid)
    with pytest.raises(TypeError, match="dtype"):
        ST.matmat(W.to(torch.int32), *grid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("n", [1, 105, 4096])
def test_jacobi_kernels_match_plain(card, n, dtype):
    suffix = _suffix(dtype)
    for k in WIDTHS:
        d = torch.empty(n, dtype=dtype, device=card).uniform_(-3.0, 5.0)
        s = torch.linspace(-2.0, 4.0, k, dtype=dtype, device=card)
        s[0] = d[n // 2]                        # the eps clamp fires
        for X, vector in _blocks(n, k, dtype, card):
            for eps in (1e-10, 0.5):
                before = dict(JK.KERNEL_LAUNCHES)
                vec_before = dict(JK.VECTOR_LAUNCHES)
                y = JK.shifted(X, d, s, eps)
                z = JK.unshifted(X, d, eps)
                bumped = {"jacobi_shifted_" + suffix: 1, "jacobi_" + suffix: 1}
                assert JK.KERNEL_LAUNCHES == {
                    e: c + bumped.get(e, 0) for e, c in before.items()}
                assert JK.VECTOR_LAUNCHES == {
                    e: c + vector * bumped.get(e, 0)
                    for e, c in vec_before.items()}
                assert _same(y, JK.shifted_reference(X, d, s, eps))
                assert _same(z, JK.unshifted_reference(X, d, eps))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
def test_jacobi_kernels_on_many_blocks(card, dtype):
    # a million rows: thousands of blocks, each thread four rows
    n = (1 << 20) + 3
    d = torch.empty(n, dtype=dtype, device=card).uniform_(1.0, 5.0)
    for k in (1, 2, 3):
        for X, _ in _blocks(n, k, dtype, card):
            p = JK.card_plan(X)
            assert p.blocks > 1000
            s = torch.rand(k, dtype=dtype, device=card)
            assert _same(JK.shifted(X, d, s, 1e-10),
                         JK.shifted_reference(X, d, s, 1e-10))
            assert _same(JK.unshifted(X, d, 1e-10),
                         JK.unshifted_reference(X, d, 1e-10))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
def test_jacobi_kernels_column_slice_and_nonfinite(card, dtype):
    n = 105
    d = torch.empty(n, dtype=dtype, device=card).uniform_(1.0, 5.0)
    d[7], d[9] = float("nan"), 0.0
    W = torch.randn((n, 20), dtype=dtype, device=card)
    W[3, 2], W[4, 5] = float("nan"), float("inf")
    W[6, 3], W[8, 4] = -float("inf"), float("nan")
    X = W[:, 2:15]
    s = torch.randn(13, dtype=dtype, device=card)
    s[4] = float("nan")
    assert _same(JK.shifted(X, d, s, 1e-10),
                 JK.shifted_reference(X.contiguous(), d, s, 1e-10))
    assert _same(JK.unshifted(X, d, 1e-10),
                 JK.unshifted_reference(X.contiguous(), d, 1e-10))
    for off in (2, 3):                          # k = 2: vector and scalar
        X2, s2 = W[:, off:off + 2], s[:2]
        assert _same(JK.shifted(X2, d, s2, 1e-10),
                     JK.shifted_reference(X2, d, s2, 1e-10))
        assert _same(JK.unshifted(X2, d, 1e-10),
                     JK.unshifted_reference(X2, d, 1e-10))
    with pytest.raises(ValueError, match="sigma"):
        JK.shifted(X, d, s[:3], 1e-10)
    with pytest.raises(TypeError, match="dtype"):
        JK.shifted(X, d.to(torch.int32), s, 1e-10)
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
