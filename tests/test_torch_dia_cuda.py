"""The hand-written DIA kernel (csrc/dia.cu) against its plain PyTorch
version on the card, and the formats that run on it and on the sliced-ELL
kernel fed from CSR (BandedOperator, ELLOperator, the DIA+ELL hybrid).
This file imports no jax, so that it runs where the kernels do:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_dia_cuda.py

Tolerance: none for the DIA kernel. It rounds once per operation in the
plain version's order (no fma contraction), so they agree bit for bit, NaN
for NaN, on the vector path and on the scalar one (a column slice at an odd
offset), in both modes. The sliced-ELL kernel sums with fma, so the formats
on it are held to 1e-5 (f32) and 1e-13 (f64) of max|y|, as its own tests
hold it. Every test here needs a card and skips without one."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import primme_tpu_torch as ptt
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import windowed_ell as WE

TYPES = [torch.float32, torch.float64]
WIDTHS = (1, 2, 3, 4, 8, 13)
# (n, offsets in stored order): a tridiagonal, unsorted offsets past n/2,
# one diagonal off the main one, a 27-point stencil's 27 on a 5^3 grid, and
# a size that is no multiple of the block's 256 rows
CASES = [(300, (-1, 0, 1)), (300, (5, -3, 0, 151, -170, 299, -299)),
         (1000, (7,)), (125, tuple(a * 25 + b * 5 + c for a in (-1, 0, 1)
                                   for b in (-1, 0, 1) for c in (-1, 0, 1))),
         (70001, (0, 1, -1, 4096, -4096, 64, -64))]
REL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _offs(offsets, device):
    return torch.tensor(offsets, dtype=torch.int64, device=device)


def _same(a, b):
    torch.cuda.synchronize()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _blocks(n, k, dtype, card):
    """Column blocks of width k: contiguous, and slices of a 24-wide block
    at an even and an odd column offset."""
    W = torch.randn((n, 24), dtype=dtype, device=card)
    out = [torch.randn((n, k), dtype=dtype, device=card)]
    for off in (2, 1):
        if off + k <= 24:
            out.append(W[:, off:off + k])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dia_kernel_matches_plain(card, case, dtype):
    n, offs = CASES[case]
    vals = torch.randn((len(offs), n), dtype=dtype, device=card)
    dev_offs = _offs(offs, card)
    entry = "dia_" + ("f32" if dtype == torch.float32 else "f64")
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
@pytest.mark.parametrize("dtype", TYPES)
def test_dia_kernel_nan_inf_and_signed_zero(card, dtype):
    # an off-edge term is v * 0 (NaN for an Inf or NaN v), a -0 term on a
    # +0 sum gives +0: as the plain version
    n, offs = 257, (3, 0, -2)
    vals = torch.randn((3, n), dtype=dtype, device=card)
    vals[0, -1] = float("inf")          # off the edge: inf * 0
    vals[2, 0] = float("nan")           # off the edge: nan * 0
    vals[1, 10] = -0.0
    X = torch.randn((n, 2), dtype=dtype, device=card)
    X[10] = -0.0
    X[50, 1] = float("inf")
    for adjoint, plain in ((False, DK.matmat_reference),
                           (True, DK.rmatmat_reference)):
        y = DK.matmat(vals, _offs(offs, card), X, adjoint=adjoint)
        ref = plain(vals, offs, X)
        assert _same(y, ref) and torch.equal(torch.signbit(y),
                                             torch.signbit(ref))


@pytest.mark.cuda
def test_dia_wrapper_refuses(card):
    vals = torch.randn((2, 64), device=card)
    X = torch.randn((64, 2), device=card)
    offs = _offs((0, 1), card)
    with pytest.raises(TypeError, match="X has dtype"):
        DK.matmat(vals, offs, X.double())
    with pytest.raises(TypeError, match="offs has dtype"):
        DK.matmat(vals, offs.int(), X)
    with pytest.raises(ValueError, match="offs shape"):
        DK.matmat(vals, offs[:1], X)
    with pytest.raises(ValueError, match="on cpu"):
        DK.matmat(vals, offs.cpu(), X)
    with pytest.raises(ValueError, match="columns are not adjacent"):
        DK.matmat(vals, offs, X.t().contiguous().t())
    with pytest.raises(ValueError, match="X shape"):
        DK.matmat(vals, offs, X[:63])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_formats_on_the_card(card, dtype):
    # the chooser's banded and hybrid operators, and an ELLOperator with
    # empty rows and slices, on the card against the same operators on the
    # CPU (the plain versions)
    rng = np.random.default_rng(0)
    n = 2500
    T = sp.diags([np.full(n - 1, -1.), np.arange(1., n + 1),
                  np.full(n - 1, -1.)], [-1, 0, 1])
    S = sp.random(n, n, density=1e-4, random_state=1)
    mats = {"banded": T.tocsr(), "hybrid": (T + S + S.T).tocsr()}
    E = sp.random(n, n, density=2e-3, random_state=2, format="lil")
    E[100:400] = 0
    mats["ell"] = E.tocsr()
    ops = {"banded": lambda A: ptt.rcm_banded(A)[0],
           "hybrid": lambda A: ptt.rcm_banded(A)[0],
           "ell": ptt.ELLOperator.from_scipy}
    kinds = {"banded": ptt.BandedOperator, "hybrid": ptt.SumOperator,
             "ell": ptt.ELLOperator}
    for name, A in mats.items():
        A = A.astype(dtype)
        op = ops[name](A)
        assert isinstance(op, kinds[name]), name
        X = torch.as_tensor(rng.normal(size=(n, 3)).astype(dtype))
        cpu = op.matmat(X), op.rmatmat(X)
        op = op.to(card)
        d0 = dict(DK.KERNEL_LAUNCHES), dict(WE.KERNEL_LAUNCHES)
        gpu = op.matmat(X.to(card)), op.rmatmat(X.to(card))
        launched = (DK.KERNEL_LAUNCHES != d0[0], WE.KERNEL_LAUNCHES != d0[1])
        assert launched == {"banded": (True, False), "hybrid": (True, True),
                            "ell": (False, True)}[name], name
        rel = REL[getattr(torch, np.dtype(dtype).name)]
        for c, g in zip(cpu, gpu):
            assert float((g.cpu() - c).abs().max()) \
                <= rel * float(c.abs().max()), name
