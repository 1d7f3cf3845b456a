"""The f16 and bf16 entry points of the hand-written kernels
(``csrc/stencil3d.cu``, ``jacobi.cu``, ``dia.cu``, ``windowed_ell.cu``)
against their plain PyTorch versions on the card, and half solves through
them. This file imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_half_ops_cuda.py

Tolerances: none for the stencil, Jacobi and DIA (every operation of
theirs is one half operation, f32 on the exact operands rounded once to
the half type, in the plain version's order: bit for bit, NaN for NaN,
on the vector path and on the scalar one, on blocks drawn from edge
values too); one unit in the half's last
place for the sliced ELL (an f32 fma chain against the plain version's
rounded products and sums in f32, the sum rounded once to the half type;
both paths). The mixed entry points (half values or diagonal, an f32 or
f64 block: what a half basis hands a half operator): bit for bit against
their plain versions for Jacobi and DIA, and for DIA and the sliced ELL
also bit for bit against the f32 (f64) kernel on the widened values (the
same fma chain); the sliced ELL within its block type's bar of the plain
version (rounded products and sums: 1e-5 and 1e-13 of max|y|, as the f32
and f64 kernels are held). Every test here needs a card and skips
without one."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST
from primme_tpu_torch.ops import windowed_ell as WE

HALVES = [torch.float16, torch.bfloat16]
SUFFIX = {torch.float16: "f16", torch.bfloat16: "bf16"}
WIDTHS = (1, 2, 3, 4, 8, 13)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    torch.cuda.synchronize()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a.float()), torch.nan_to_num(b.float()))


def _within_ulp(a, b):
    """|a - b| at most one unit in the last place of the half value b."""
    torch.cuda.synchronize()
    fi = torch.finfo(b.dtype)
    mag = b.float().abs().clamp_min(fi.tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * fi.eps
    return a.dtype == b.dtype and bool(
        ((a.float() - b.float()).abs() <= ulp).all())


def _blocks(n, k, dtype, card):
    """Column blocks of width k: contiguous, and slices of a 24-wide block
    at a column offset of 8 (16-byte aligned rows) and 1 (the scalar
    path)."""
    W = torch.randn((n, 24), device=card).to(dtype)
    out = [torch.randn((n, k), device=card).to(dtype)]
    for off in (8, 1):
        if off + k <= 24:
            out.append(W[:, off:off + k])
    return out


# values at the edges of each half type: signed zeros, subnormals (the
# least, the largest, and the least normal beside them), the largest finite
# values, and values whose sums and products fall on a tie of the half
# grid (1 + eps/2 past 1, 1 - eps/4 below it, 0.5 + eps/4, 3, 1.5)
EDGE = {torch.float16: [0.0, -0.0, 1.0, -1.0, 1 + 2 ** -10, 1 - 2 ** -11,
                        2 ** -11, -2 ** -11, 3.0, 1.5, 0.5 + 2 ** -11,
                        65504.0, -65504.0, 2 ** -24, -2 ** -24,
                        2 ** -14 - 2 ** -24, 2 ** -14],
        torch.bfloat16: [0.0, -0.0, 1.0, -1.0, 1 + 2 ** -7, 1 - 2 ** -8,
                         2 ** -8, -2 ** -8, 3.0, 1.5, 0.5 + 2 ** -8,
                         3.3895313892515355e38, -3.3895313892515355e38,
                         2 ** -133, -2 ** -133, 2 ** -126 - 2 ** -133,
                         2 ** -126]}


def _edge(shape, dtype, card, seed):
    """A tensor of ``shape`` drawn (seeded) from ``EDGE[dtype]``, each value
    exact in the half type."""
    pool = torch.tensor(EDGE[dtype], dtype=torch.float32)
    assert torch.equal(pool.to(dtype).float(), pool)
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(len(pool), shape, generator=g)
    return pool[idx].to(dtype).to(card)


def _edge_blocks(n, k, dtype, card, seed):
    """:func:`_blocks`' three blocks, drawn from the edge values."""
    W = _edge((n, 24), dtype, card, seed)
    out = [_edge((n, k), dtype, card, seed + 1)]
    for off in (8, 1):
        if off + k <= 24:
            out.append(W[:, off:off + k])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["randn", "edge"])
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("grid", [(3, 5, 7), (16, 16, 16), (17, 33, 65)])
def test_half_stencil_matches_plain(card, grid, dtype, values):
    """Every width on contiguous blocks and slices; ``edge``: blocks drawn
    from ``EDGE`` (a one-column block on an even nz takes the paired
    path, on an odd nz the scalar pairs)."""
    n = grid[0] * grid[1] * grid[2]
    entry = "stencil3d_" + SUFFIX[dtype]
    for k in WIDTHS:
        blocks = (_blocks(n, k, dtype, card) if values == "randn"
                  else _edge_blocks(n, k, dtype, card, k))
        for X in blocks:
            before = ST.KERNEL_LAUNCHES[entry]
            Y = ST.matmat(X, *grid, scale=0.37)
            assert ST.KERNEL_LAUNCHES[entry] == before + 1
            assert _same(Y, ST.matmat_reference(X.contiguous(), *grid,
                                                scale=0.37)), (k, grid)
    # eight halves a point: 16-byte vector loads
    v0 = ST.VECTOR_LAUNCHES[entry]
    X = torch.randn((n, 8), device=card).to(dtype)
    assert _same(ST.matmat(X, *grid), ST.matmat_reference(X, *grid))
    assert ST.card_plan(X, *grid).vw == 8
    assert ST.VECTOR_LAUNCHES[entry] == v0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALVES)
def test_half_jacobi_matches_plain(card, dtype):
    """Shifted and unshifted, a shift equal to a diagonal entry and a zero
    diagonal entry (f16: eps is 0 there, the quotient infinite; bf16: the
    guard's 1e-10)."""
    n = 4099
    d = (torch.rand(n, device=card) * 3 + 0.5).to(dtype)
    d[3] = 0
    for k in WIDTHS:
        s = (torch.rand(k, device=card) * 3 + 0.5).to(dtype)
        s[0] = d[5]
        for X in _blocks(n, k, dtype, card):
            b0 = dict(JK.KERNEL_LAUNCHES)
            Y = JK.shifted(X, d, s, 1e-10)
            assert JK.KERNEL_LAUNCHES["jacobi_shifted_" + SUFFIX[dtype]] \
                == b0["jacobi_shifted_" + SUFFIX[dtype]] + 1
            assert _same(Y, JK.shifted_reference(X.contiguous(), d, s,
                                                 1e-10)), k
            assert _same(JK.unshifted(X, d, 1e-10),
                         JK.unshifted_reference(X.contiguous(), d, 1e-10)), k
    col = JK.shifted(torch.ones((n, 1), device=card, dtype=dtype), d,
                     d[5:6].clone(), 1e-10)[5, 0].item()
    assert (col == float("inf")) if dtype == torch.float16 else \
        (np.isfinite(col) and col > 1e6)


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["randn", "edge"])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("dtype", HALVES)
def test_half_dia_matches_plain(card, dtype, adjoint, values):
    """``randn``: every width on contiguous blocks and slices. ``edge``:
    values and blocks drawn from ``EDGE``, odd offsets at an odd n (a k=1
    block's X is one run of rows, which a shift puts at an odd half, as it
    does the runs of values at odd rows of vals; the other blocks take two
    rows a thread, 32 apart)."""
    if values == "randn":
        n, offsets = 5000, (0, 1, -1, 64, -64, 4095)
        vals = torch.randn((len(offsets), n), device=card).to(dtype)
    else:
        n, offsets = 5001, (0, 1, -1, 3, -5, 63, -65, 4095, -4097)
        vals = _edge((len(offsets), n), dtype, card, 7)
    offs = torch.tensor(offsets, device=card)
    entry = "dia_" + SUFFIX[dtype]
    ref = DK.rmatmat_reference if adjoint else DK.matmat_reference
    for k in WIDTHS:
        blocks = (_blocks(n, k, dtype, card) if values == "randn"
                  else _edge_blocks(n, k, dtype, card, k))
        for X in blocks:
            before = DK.KERNEL_LAUNCHES[entry]
            Y = DK.matmat(vals, offs, X, adjoint=adjoint)
            assert DK.KERNEL_LAUNCHES[entry] == before + 1
            assert _same(Y, ref(vals, offsets, X.contiguous())), k


BLOCKS = [torch.float32, torch.float64]
BLOCK_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtype", HALVES)
def test_mixed_jacobi_matches_plain(card, dtype, block):
    """A half diagonal with a wider block and shifts: shifted (d widened,
    the rest in the block's type) and unshifted (the reciprocal in the half
    type, the product in the block's), a shift equal to a diagonal entry
    and a zero diagonal entry included."""
    n = 4099
    d = (torch.rand(n, device=card) * 3 + 0.5).to(dtype)
    d[3] = 0
    sfx = f"{SUFFIX[dtype]}_{BLOCK_SUFFIX[block]}"
    for k in WIDTHS:
        s = (torch.rand(k, device=card) * 3 + 0.5).to(block)
        s[0] = d[5]
        for X in _blocks(n, k, block, card):
            b0 = dict(JK.KERNEL_LAUNCHES)
            Y = JK.shifted(X, d, s, 1e-10)
            Yu = JK.unshifted(X, d, 1e-10)
            assert JK.KERNEL_LAUNCHES["jacobi_shifted_" + sfx] \
                == b0["jacobi_shifted_" + sfx] + 1
            assert JK.KERNEL_LAUNCHES["jacobi_" + sfx] \
                == b0["jacobi_" + sfx] + 1
            assert _same(Y, JK.shifted_reference(X.contiguous(), d, s,
                                                 1e-10)), k
            assert _same(Yu, JK.unshifted_reference(X.contiguous(), d,
                                                    1e-10)), k


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtype", HALVES)
def test_mixed_dia_matches_plain(card, dtype, block):
    n, offsets = 5000, (0, 1, -1, 64, -64, 4095)
    vals = torch.randn((len(offsets), n), device=card).to(dtype)
    offs = torch.tensor(offsets, device=card)
    entry = f"dia_{SUFFIX[dtype]}_{BLOCK_SUFFIX[block]}"
    for adjoint in (False, True):
        ref = DK.rmatmat_reference if adjoint else DK.matmat_reference
        for k in WIDTHS:
            for X in _blocks(n, k, block, card):
                before = DK.KERNEL_LAUNCHES[entry]
                Y = DK.matmat(vals, offs, X, adjoint=adjoint)
                assert DK.KERNEL_LAUNCHES[entry] == before + 1
                assert _same(Y, ref(vals, offsets, X.contiguous())), k
                assert _same(Y, DK.matmat(vals.to(block), offs, X,
                                          adjoint=adjoint)), k


def _half_ell(m, n, density, seed, dtype, card):
    A = sp.random(m, n, density=density, random_state=seed, format="csr",
                  dtype=np.float32)
    rng = np.random.default_rng(seed)
    A.data = rng.standard_normal(A.nnz).astype(np.float32)
    coo = A.tocoo()
    return ptt.ELLOperator.from_coo(
        coo.row, coo.col, torch.tensor(coo.data).to(dtype), A.shape).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("shape", [(3000, 3000, 0.004), (4000, 1500, 0.02)])
def test_half_sliced_ell_matches_plain(card, shape, dtype):
    """Both paths (ring and direct), every width (vector gathers of 2, 4
    and 8 halves, and the scalar path): within one unit in the half's last
    place of the plain version, and the two paths the same bit for bit."""
    op = _half_ell(*shape, 11, dtype, card)
    entry = "windowed_ell_spmm_" + SUFFIX[dtype]
    lay = [op.slice_ptr, op.rowlen, op.cols, op.vals]
    for k in WIDTHS:
        for X in _blocks(shape[1], k, dtype, card):
            X = X.contiguous()
            ref = WE.matmat_reference(*lay, X, shape[1])
            outs = []
            for path in WE.PATHS:
                before = WE.KERNEL_LAUNCHES[entry]
                outs.append(WE.matmat(*lay, X, shape[1], path=path))
                assert WE.KERNEL_LAUNCHES[entry] == before + 1
                assert _within_ulp(outs[-1], ref), (k, path)
            assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("dtype", HALVES)
@pytest.mark.parametrize("shape", [(3000, 3000, 0.004), (4000, 1500, 0.02)])
def test_mixed_sliced_ell_matches_plain(card, shape, dtype, block):
    """Half values with a wider block, both paths, every width: within the
    block type's bar of the plain version, bit for bit with the block
    type's kernel on the widened values and across the two paths."""
    op = _half_ell(*shape, 11, dtype, card)
    entry = f"windowed_ell_spmm_{SUFFIX[dtype]}_{BLOCK_SUFFIX[block]}"
    rel = 1e-5 if block == torch.float32 else 1e-13
    lay = [op.slice_ptr, op.rowlen, op.cols, op.vals]
    wide = lay[:3] + [op.vals.to(block)]
    for k in WIDTHS:
        for X in _blocks(shape[1], k, block, card):
            X = X.contiguous()
            ref = WE.matmat_reference(*lay, X, shape[1])
            for path in WE.PATHS:
                before = WE.KERNEL_LAUNCHES[entry]
                Y = WE.matmat(*lay, X, shape[1], path=path)
                assert WE.KERNEL_LAUNCHES[entry] == before + 1
                assert Y.dtype == block
                assert float((Y - ref).abs().max()) \
                    <= rel * float(ref.abs().max()), (k, path)
                assert _same(Y, WE.matmat(*wide, X, shape[1], path=path))


@pytest.mark.cuda
def test_half_basis_runs_mixed_kernels(card):
    """A bf16 tridiagonal BandedOperator with its Jacobi over a half basis
    (``dtype=None``): its gates (true residuals and values within 16
    eps(bf16) ||A||), the mixed DIA entry point launched at least
    matvecs/2 times and the shifted Jacobi's at least once, no f32 or half
    entry point of them."""
    m = 2000
    Tm = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                  [-1, 0, 1]).tocsr()
    band = ptt.BandedOperator((-1, 0, 1), torch.tensor(
        np.stack([-np.ones(m), 2 * np.ones(m), -np.ones(m)])).to(
        torch.bfloat16)).to(card)
    b0, j0 = dict(DK.KERNEL_LAUNCHES), dict(JK.KERNEL_LAUNCHES)
    eps = float(torch.finfo(torch.bfloat16).eps)
    w, V, st = ptt.eigsh(band, k=3, which="LA", tol=4 * eps,
                         OPinv=ptt.JacobiPrecond(band.diagonal()),
                         return_stats=True)
    exact = 2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    floor = 16 * eps * 4
    R = Tm @ V.astype(np.float64) - V * w[None, :]
    assert np.linalg.norm(R, axis=0).max() < floor
    assert np.abs(exact[None, :] - w[:, None]).min(axis=1).max() < floor
    assert DK.KERNEL_LAUNCHES["dia_bf16_f32"] - b0["dia_bf16_f32"] \
        >= st["num_matvecs"] / 2
    for e in ("dia_f32", "dia_bf16"):
        assert DK.KERNEL_LAUNCHES[e] == b0[e]
    assert JK.KERNEL_LAUNCHES["jacobi_shifted_bf16_f32"] \
        > j0["jacobi_shifted_bf16_f32"]
    for e in ("jacobi_shifted_f32", "jacobi_shifted_bf16"):
        assert JK.KERNEL_LAUNCHES[e] == j0[e]


@pytest.mark.cuda
def test_half_solves_run_their_kernels(card):
    """An f16 16^3 stencil with its Jacobi under an f32 solve and a bf16
    tridiagonal BandedOperator under an f32 solve, on the card: the
    half basis' gates (true residuals and values within 16 eps(half)
    ||A||), the half kernels launched at least matvecs/2 times, their f32
    counterparts not at all."""
    n = 16
    lam = 2 - 2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
    spectrum = np.sort(np.add.outer(np.add.outer(lam, lam), lam).ravel())
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1])
    eye = sp.identity(n)
    A = (sp.kron(sp.kron(T, eye), eye) + sp.kron(sp.kron(eye, T), eye)
         + sp.kron(sp.kron(eye, eye), T)).tocsr()
    eps = float(torch.finfo(torch.float16).eps)
    op = ptt.Stencil3DOperator(n, n, n, dtype=torch.float16)
    K = ptt.JacobiPrecond(op.diagonal())
    s0, j0 = dict(ST.KERNEL_LAUNCHES), dict(JK.KERNEL_LAUNCHES)
    w, V, st = ptt.eigsh(op, k=4, which="SA", tol=4 * eps, OPinv=K,
                         dtype=torch.float32, return_stats=True,
                         method="PRIMME_JDQMR_ETol", maxBlockSize=2)
    mv = st["num_matvecs"]
    R = A @ V.astype(np.float64) - V * w[None, :]
    floor = 16 * eps * spectrum.max()
    assert np.linalg.norm(R, axis=0).max() < floor
    assert np.abs(spectrum[None, :] - w[:, None]).min(axis=1).max() < floor
    assert ST.KERNEL_LAUNCHES["stencil3d_f16"] - s0["stencil3d_f16"] \
        >= mv / 2
    assert ST.KERNEL_LAUNCHES["stencil3d_f32"] == s0["stencil3d_f32"]
    assert JK.KERNEL_LAUNCHES["jacobi_shifted_f16"] \
        > j0["jacobi_shifted_f16"]
    assert JK.KERNEL_LAUNCHES["jacobi_shifted_f32"] \
        == j0["jacobi_shifted_f32"]
    m = 2000
    Tm = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                  [-1, 0, 1]).tocsr()
    band = ptt.BandedOperator((-1, 0, 1), torch.tensor(
        np.stack([-np.ones(m), 2 * np.ones(m), -np.ones(m)])).to(
        torch.bfloat16)).to(card)
    b0 = dict(DK.KERNEL_LAUNCHES)
    eps = float(torch.finfo(torch.bfloat16).eps)
    w, V, st = ptt.eigsh(band, k=3, which="LA", tol=4 * eps,
                         dtype=torch.float32, return_stats=True)
    exact = 2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    floor = 16 * eps * 4
    R = Tm @ V.astype(np.float64) - V * w[None, :]
    assert np.linalg.norm(R, axis=0).max() < floor
    assert np.abs(exact[None, :] - w[:, None]).min(axis=1).max() < floor
    assert DK.KERNEL_LAUNCHES["dia_bf16"] - b0["dia_bf16"] \
        >= st["num_matvecs"] / 2
    assert DK.KERNEL_LAUNCHES["dia_f32"] == b0["dia_f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALVES)
def test_half_entry_points_raise_not_fall_back(card, dtype, monkeypatch):
    """A refused launch of a half entry point raises, and so does a
    failed build: neither runs the plain version in its place."""
    from primme_tpu_torch.ops import build

    n, offsets = 300, (0, 1, -1)
    vals = torch.randn((3, n), device=card).to(dtype)
    offs = torch.tensor(offsets, device=card)
    X = torch.randn((n, 2), device=card).to(dtype)
    Y = torch.empty_like(X)
    with pytest.raises(RuntimeError, match="launch failed"):
        DK.launch(vals, offs, X, Y, False,
                  DK.card_plan(X)._replace(kernel=3))
    grid = (3, 10, 10)
    with pytest.raises(RuntimeError, match="launch failed"):
        ST.launch(X, Y, *grid, 1.0, ST.card_plan(X, *grid)._replace(vw=3))

    def broken(name):
        raise RuntimeError(f"nvcc for {name}.cu failed (1)")

    monkeypatch.setattr(build, "load", broken)
    before = (dict(DK.KERNEL_LAUNCHES), dict(ST.KERNEL_LAUNCHES))
    with pytest.raises(RuntimeError, match="nvcc for dia.cu"):
        DK.matmat(vals, offs, X)
    with pytest.raises(RuntimeError, match="nvcc for stencil3d.cu"):
        ST.matmat(X, *grid)
    assert (dict(DK.KERNEL_LAUNCHES), dict(ST.KERNEL_LAUNCHES)) == before
