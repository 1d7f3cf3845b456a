"""The compact warp-sliced layout of the port's sparse product
(``compact`` and ``matmat_reference`` in primme_tpu_torch/ops/windowed_ell.py)
and its hand-written kernel on the card. This file imports no jax, so that
its card-only tests run where the kernel does:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_sliced_ell.py

Tolerances: ``compact`` moves the packed layout's non-zero slots and must
keep each row's (column, value) sequence bit for bit, and the plain
product on it must equal the packed layout's own gather bit for bit (the
same terms in the same order). The kernel sums the same terms in the same
order with fma, so it is held to its plain version within 1e-5 of max|y|
in f32 and 1e-13 in f64 (an fma rounds once per term where the plain
version rounds twice)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from primme_tpu_torch.ops import windowed_ell as WE
from primme_tpu_torch.operators import WindowedELLOperator
from test_torch_problems import laplacian27_permuted

REL = 1e-5


def band_matrix(n, bw, seed=0, density=8):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for _ in range(density):
        d = int(rng.integers(-bw, bw + 1))
        m = n - abs(d)
        rows.append(np.arange(m) + max(0, -d))
        cols.append(np.arange(m) + max(0, d))
        vals.append(rng.normal(size=m))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def rel_err(y, yref):
    return np.abs(y - yref).max() / max(np.abs(yref).max(), 1e-30)


def packed_meta(packed):
    return (packed.nrb, packed.S, packed.npad, packed.n, packed.pad,
            packed.WB)


def layout_arrays(op):
    return op.slice_ptr, op.rowlen, op.cols, op.vals


def apply_ref(packed, X):
    lay = WE.compact(packed.scal, packed.offs, packed.vals, packed_meta(packed))
    return WE.matmat_reference(*(torch.as_tensor(a) for a in lay),
                               torch.as_tensor(X)).numpy()


def packed_gather(packed, X):
    """The plain product on the packed layout itself: every slot in slot
    order, y = y + v*g, columns outside [0, n) (parked padding) adding
    nothing; padding slots add 0*g."""
    nrb, S, npad, n, pad, WB = packed_meta(packed)
    scal = torch.as_tensor(packed.scal).to(torch.int64)
    rel = scal[nrb:].reshape(nrb, S)
    rowoff = 128 * (torch.arange(WE.RB) // 128)
    base = scal[:nrb, None] * WB + rel * 128 - pad
    offs = torch.as_tensor(packed.offs).reshape(nrb, S, WE.RB)
    vals = torch.as_tensor(packed.vals).reshape(nrb, S, WE.RB)
    X = torch.as_tensor(X)
    y = torch.zeros((nrb, WE.RB, X.shape[1]), dtype=vals.dtype)
    for s in range(S):
        c = base[:, s, None] + rowoff[None, :] + offs[:, s]
        v = torch.where((c >= 0) & (c < n), vals[:, s], 0.0)
        y = y + v[:, :, None] * X[c.clamp(0, n - 1)]
    return y.reshape(npad, -1)[:n]


def case_matrix(case, dtype=np.float32):
    if case == "band3000":
        return band_matrix(3000, bw=700, seed=2).astype(dtype)
    if case == "band2200_edges":
        return band_matrix(2200, bw=900, seed=5, density=12).astype(dtype)
    if case == "band2048":
        return band_matrix(2048, bw=300, seed=7).astype(dtype)
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    A = laplacian27_permuted(16)[0].astype(dtype)          # lap16_permuted_rcm
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    return A[perm][:, perm].tocsr()


CASES = ["band3000", "band2200_edges", "band2048", "lap16_permuted_rcm"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_compact_keeps_each_rows_nonzero_slots(case, dtype):
    A = case_matrix(case, dtype)
    n = A.shape[0]
    p = WE.pack(A, dtype=dtype)
    lay = WE.compact(p.scal, p.offs, p.vals, packed_meta(p))
    E = len(lay.cols)
    assert lay.slice_ptr.dtype == np.int64 and lay.rowlen.dtype == np.int32
    assert lay.cols.dtype == np.int32 and lay.vals.dtype == dtype
    assert lay.slice_ptr.shape == (-(-n // 32) + 1,) and lay.rowlen.shape == (n,)
    assert lay.vals.shape == (E,) and E == lay.slice_ptr[-1]
    assert A.nnz <= E <= p.nrb * p.S * WE.RB
    assert lay.cols.min() >= 0 and lay.cols.max() < n
    # a slice spans 32 * its longest row (16-byte chunks for bulk copies)
    width = np.diff(lay.slice_ptr) // 32
    assert np.all(np.diff(lay.slice_ptr) % 32 == 0)
    padded = np.zeros(32 * len(width), np.int32)
    padded[:n] = lay.rowlen
    assert np.array_equal(width, padded.reshape(-1, 32).max(axis=1))
    # the packed layout's non-zero slots, row by row in slot order
    # (row-major over [row, slot], another route than compact's ranks)
    nrb, S, _, _, pad, WB = packed_meta(p)
    vals = p.vals.reshape(nrb, S, WE.RB).transpose(0, 2, 1).reshape(-1, S)
    offs = p.offs.reshape(nrb, S, WE.RB).transpose(0, 2, 1).reshape(-1, S)
    rows, slots = np.nonzero(vals[:n] != 0)
    b = rows // WE.RB
    rel = p.scal[nrb:].reshape(nrb, S).astype(np.int64)
    want_c = (p.scal[b].astype(np.int64) * WB + rel[b, slots] * 128
              + 128 * ((rows % WE.RB) // 128) + offs[rows, slots] - pad)
    want_v = vals[rows, slots]
    assert np.array_equal(lay.rowlen, np.bincount(rows, minlength=n))
    j = np.arange(len(rows)) - np.repeat(
        np.cumsum(lay.rowlen) - lay.rowlen, lay.rowlen)
    at = lay.slice_ptr[rows // 32] + 32 * j + rows % 32
    assert np.array_equal(lay.cols[at], want_c)
    assert lay.vals[at].tobytes() == want_v.tobytes()
    # what is left is padding: column 0, value 0
    rest = np.ones(E, bool)
    rest[at] = False
    assert not lay.cols[rest].any() and not lay.vals[rest].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["band2200_edges", "lap16_permuted_rcm"])
def test_plain_product_equals_packed_gather(case, dtype):
    A = case_matrix(case, dtype)
    p = WE.pack(A, dtype=dtype)
    X = np.random.default_rng(3).normal(size=(A.shape[0], 3)).astype(dtype)
    y = torch.as_tensor(apply_ref(p, X))
    assert torch.equal(y, packed_gather(p, X))


def test_compact_drops_explicit_zeros():
    A = band_matrix(2048, bw=300, seed=7).astype(np.float32)
    A.data[::5] = 0.0                     # stored, but zero
    p = WE.pack(A)
    lay = WE.compact(p.scal, p.offs, p.vals, packed_meta(p))
    assert lay.rowlen.sum() == A.count_nonzero() < A.nnz
    X = np.random.default_rng(8).normal(size=(2048, 2)).astype(np.float32)
    yref = A.astype(np.float64) @ X.astype(np.float64)
    assert rel_err(apply_ref(p, X), yref) < REL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_product_applies_no_padding_term(dtype):
    # Inf/NaN in X reach exactly the rows that hold its column: padding
    # entries (column 0) add no 0*x term
    A = case_matrix("lap16_permuted_rcm", dtype)
    op = WindowedELLOperator.from_scipy(A)
    X = np.ones((A.shape[0], 2), dtype)
    X[0, 0], X[0, 1] = np.nan, np.inf
    y = WE.matmat_reference(*layout_arrays(op), torch.as_tensor(X)).numpy()
    hit = A[:, 0].toarray()[:, 0] != 0
    assert np.array_equal(np.isnan(y[:, 0]), hit)
    assert np.array_equal(~np.isfinite(y[:, 1]), hit)


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    A = band_matrix(3000, bw=700, seed=2).astype(np.float32)
    op = WindowedELLOperator.from_scipy(A).to("cuda")
    for k in (1, 2, 3, 8, 11):
        X = torch.randn((3000, k), device="cuda")
        before = WE.LAUNCHES
        y = WE.matmat(*layout_arrays(op), X)
        torch.cuda.synchronize()
        assert WE.LAUNCHES == before + 1
        yref = WE.matmat_reference(*layout_arrays(op), X)
        assert float((y - yref).abs().max()) <= REL * float(yref.abs().max())


@pytest.mark.cuda
def test_f64_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    A = band_matrix(3000, bw=700, seed=11)
    op = WindowedELLOperator.from_scipy(A).to("cuda")
    assert op.dtype == torch.float64
    for k in (1, 2, 3, 8, 11):
        X = torch.randn((3000, k), device="cuda", dtype=torch.float64)
        before = dict(WE.KERNEL_LAUNCHES)
        y = WE.matmat(*layout_arrays(op), X)
        torch.cuda.synchronize()
        assert WE.KERNEL_LAUNCHES == {
            **before, "windowed_ell_spmm_f64":
            before["windowed_ell_spmm_f64"] + 1}
        yref = WE.matmat_reference(*layout_arrays(op), X)
        # the same f64 sums in the same order; fma rounds once per term
        assert float((y - yref).abs().max()) \
            <= 1e-13 * float(yref.abs().max())
    with pytest.raises(TypeError, match="dtype"):
        WE.matmat(*layout_arrays(op), X.to(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_crosses_ring_and_k_chunks_on_card(dtype):
    # rows of 27 entries span two ring stages of 16 slots, and k=11 two
    # launches (8 + 3 columns); Inf/NaN in X reach only the rows that
    # hold its column, as through the plain version
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    A = case_matrix("lap16_permuted_rcm", dtype)
    op = WindowedELLOperator.from_scipy(A).to("cuda")
    assert int(op.rowlen.max()) == 27
    X = torch.randn((A.shape[0], 11), device="cuda", dtype=op.dtype)
    X[0, 0], X[0, 9] = float("nan"), float("inf")
    y = WE.matmat(*layout_arrays(op), X)
    yref = WE.matmat_reference(*layout_arrays(op), X)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(y), torch.isfinite(yref))
    fin = torch.isfinite(yref)
    rel = REL if dtype == np.float32 else 1e-13
    assert float((y - yref)[fin].abs().max()) \
        <= rel * float(yref[fin].abs().max())
