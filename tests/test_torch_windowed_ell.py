"""The port's windowed-slot ELL SpMM (primme_tpu_torch/ops/windowed_ell.py)
against the JAX package's (primme_tpu/ops/pallas_windowed.py) and scipy.

Tolerances: ``pack`` is copied from the reference, so its arrays must be
equal; in f64 the reference splits each value into an f32 pair (hi, lo),
the port keeps it whole, so ``vals`` rounds to ``hi`` in f32 bit for bit
and lies within 2**-48 relative of ``hi + lo`` (the tail's own rounding;
exact for entries that are f32 numbers). The f32 products accumulate in
another order than scipy (f64) or the interpreted Pallas kernel, so they
are held to rel 1e-5 of max|y|, about 60 f32 ulps over slot counts of
8-64. The f64 products are held to the reference's CPU path of
``matmat_ds`` within 1e-14 of max|y| (both sum in f64 in slot order; the
inputs differ by the 2**-48 of the hi/lo split) and to scipy within 5e-14,
the JAX package's own f64 gate."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from primme_tpu import operators as JO
from primme_tpu.ops import pallas_windowed as PW
from primme_tpu_torch.ops import windowed_ell as WE
from primme_tpu_torch.operators import (CastOperator, LinearOperator,
                                        WindowedELLOperator, rcm_banded)
from test_torch_problems import laplacian27_permuted

REL = 1e-5
REL64_JAX = 1e-14
REL64_SCIPY = 5e-14


def _band_matrix(n, bw, seed=0, density=8):
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


def _rel_err(y, yref):
    return np.abs(y - yref).max() / max(np.abs(yref).max(), 1e-30)


def _apply_ref(packed, X):
    meta = (packed.nrb, packed.S, packed.npad, packed.n, packed.pad,
            packed.WB)
    return WE.matmat_reference(meta, torch.as_tensor(packed.scal),
                               torch.as_tensor(packed.offs),
                               torch.as_tensor(packed.vals),
                               torch.as_tensor(X)).numpy()


@pytest.mark.parametrize("case", ["band3000", "band2200_edges",
                                  "band2048", "lap16_permuted_rcm",
                                  "band3000_f64", "lap16_permuted_rcm_f64"])
def test_pack_matches_reference(case):
    dtype = np.float64 if case.endswith("_f64") else np.float32
    if case == "band3000":
        A = _band_matrix(3000, bw=700, seed=2)
    elif case == "band2200_edges":
        A = _band_matrix(2200, bw=900, seed=5, density=12)
    elif case == "band2048":
        A = _band_matrix(2048, bw=300, seed=7)
    elif case == "band3000_f64":
        A = _band_matrix(3000, bw=700, seed=11)
    else:
        A = laplacian27_permuted(16)[0].astype(dtype)
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        A = A[perm][:, perm]
    pj = PW.pack(A, dtype=dtype)
    pt = WE.pack(A, dtype=dtype)
    assert pj is not None and pt is not None
    # the port has no f32 tail: f64 values are one array
    assert pj._fields == pt._fields + ("vals_lo",)
    assert (pj.vals_lo is not None) == (dtype == np.float64)
    for f in pt._fields:
        a, b = getattr(pj, f), getattr(pt, f)
        if f == "vals" and dtype == np.float64:
            assert b.dtype == np.float64 and b.shape == a.shape
            assert np.array_equal(b.astype(np.float32), a)
            hilo = a.astype(np.float64) + pj.vals_lo.astype(np.float64)
            assert np.all(np.abs(b - hilo) <= 2.0 ** -48 * np.abs(b))
            if case.startswith("lap16"):      # entries 26 and -1: exact
                assert np.array_equal(b, hilo)
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


def test_pack_rejects_what_reference_rejects():
    # random scatter: the band window exceeds the budget on both sides
    n = 20000
    rng = np.random.default_rng(1)
    nnz = 200_000
    A = sp.coo_matrix((np.ones(nnz, np.float32),
                       (rng.integers(0, n, nnz), rng.integers(0, n, nnz))),
                      shape=(n, n)).tocsr()
    assert PW.pack(A) is None
    assert WE.pack(A) is None


@pytest.mark.parametrize("k", [1, 2])
def test_matmat_reference_matches_pallas_interpret(k):
    # the JAX kernel runs in interpret mode on the CPU (~2-3 s per call)
    n = 2048
    A = _band_matrix(n, bw=300, seed=7).astype(np.float32)
    packed = PW.pack(A)
    X = np.random.default_rng(k).normal(size=(n, k)).astype(np.float32)
    yj = np.asarray(PW.matmat(packed.nrb, packed.S, packed.npad, packed.n,
                              packed.pad, packed.WB,
                              jnp.asarray(packed.scal),
                              jnp.asarray(packed.offs),
                              jnp.asarray(packed.vals),
                              jnp.asarray(X, jnp.float32)))
    yt = _apply_ref(WE.pack(A), X)
    assert yt.dtype == np.float32 and yt.shape == (n, k)
    assert _rel_err(yt, yj) < REL


@pytest.mark.parametrize("case", ["lap16_permuted", "band_edges"])
def test_matmat_reference_matches_scipy(case):
    if case == "lap16_permuted":
        Ap = laplacian27_permuted(16)[0]
        op, perm = rcm_banded(Ap)
        assert isinstance(op, WindowedELLOperator)
        assert op.meta[1] == 64                      # S
        A = Ap[perm][:, perm]
    else:
        A = _band_matrix(2200, bw=900, seed=5, density=12).astype(np.float32)
        op = WindowedELLOperator.from_scipy(A)
        assert op is not None
    n = A.shape[0]
    X = np.random.default_rng(6).normal(size=(n, 3)).astype(np.float32)
    y = op.matmat(torch.as_tensor(X)).numpy()
    yref = A.astype(np.float64) @ X.astype(np.float64)
    assert _rel_err(y, yref) < REL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmat_counts_no_launch_on_cpu(dtype):
    A = _band_matrix(2048, bw=300, seed=7).astype(dtype)
    op = WindowedELLOperator.from_scipy(A)
    before, by_kernel = WE.LAUNCHES, dict(WE.KERNEL_LAUNCHES)
    op.matmat(torch.ones((2048, 2), dtype=op.dtype))
    assert WE.LAUNCHES == before and WE.KERNEL_LAUNCHES == by_kernel


@pytest.mark.parametrize("k", [1, 3, 8])
def test_f64_matmat_reference_matches_jax_and_scipy(k):
    n = 3000
    A = _band_matrix(n, bw=700, seed=11)
    jop = JO.WindowedELLOperator.from_scipy(A)
    op = WindowedELLOperator.from_scipy(A)
    assert op.dtype == torch.float64 and op.vals.dtype == torch.float64
    assert op.meta == jop.meta
    X = np.random.default_rng(12 + k).normal(size=(n, k))
    y = WE.matmat_reference(op.meta, op.scal, op.offs, op.vals,
                            torch.as_tensor(X)).numpy()
    assert y.dtype == np.float64 and y.shape == (n, k)
    yj = np.asarray(jax.jit(jop.matmat)(jnp.asarray(X)))   # matmat_ds, CPU
    assert _rel_err(y, yj) <= REL64_JAX
    assert _rel_err(y, A @ X) <= REL64_SCIPY


def test_f64_operator_on_f32_block_computes_in_f64():
    # the operator's precision decides the product, not the block's: an
    # f32 block comes back f32, rounded from the f64 product
    n = 3000
    A = _band_matrix(n, bw=700, seed=11)
    op = WindowedELLOperator.from_scipy(A)
    X = np.random.default_rng(4).normal(size=(n, 2)).astype(np.float32)
    y = op.matmat(torch.as_tensor(X))
    assert y.dtype == torch.float32
    y64 = WE.matmat_reference(op.meta, op.scal, op.offs, op.vals,
                              torch.as_tensor(X.astype(np.float64)))
    assert torch.equal(y, y64.to(torch.float32))
    # an f32 product of the same block would be ~1e-7 off, not 2**-24
    yref = A @ X.astype(np.float64)
    assert np.all(np.abs(y.numpy() - yref)
                  <= 2.0 ** -24 * np.abs(yref) + 1e-12 * np.abs(yref).max())


def test_rcm_banded_selects_windowed_for_f64():
    # the permuted band matrix of test_windowed_ell.py's f64 chooser test
    from primme_tpu.operators import rcm_banded as jrcm

    n = 8192
    A = _band_matrix(n, bw=600, seed=13, density=6)
    A = ((A + A.T) * 0.5).tocsr().astype(np.float64)
    p = np.random.default_rng(14).permutation(n)
    Ap = A[p][:, p]
    jop, jperm = jrcm(Ap, max_diags=64)         # defeat the DIA paths
    op, perm = rcm_banded(Ap, max_diags=64)
    assert isinstance(jop, JO.WindowedELLOperator)
    assert isinstance(op, WindowedELLOperator) and op.dtype == torch.float64
    assert np.array_equal(perm, jperm) and op.meta == jop.meta
    X = np.random.default_rng(15).normal(size=(n, 2))
    y = op.matmat(torch.as_tensor(X[perm])).numpy()
    assert _rel_err(y, (Ap @ X)[perm]) <= REL64_SCIPY


class _Jacobi(LinearOperator):
    """X / (d - shift), the reference's JacobiPrecond away from its eps
    guard: an operator with ``diagonal`` and ``matmat_shifted`` to hold
    :class:`CastOperator`'s other branches against the reference's."""

    def __init__(self, d):
        super().__init__()
        self.register_buffer("d", torch.as_tensor(d))
        self.shape = (len(d), len(d))
        self.dtype = self.d.dtype

    def matmat(self, X):
        return X / self.d[:, None]

    def diagonal(self):
        return self.d

    def matmat_shifted(self, X, shifts):
        return X / (self.d[:, None] - shifts[None, :])


@pytest.mark.parametrize("op_dtype,work_dtype", [
    (np.float64, np.float32), (np.float32, np.float64)])
def test_cast_operator_matches_reference(op_dtype, work_dtype):
    n = 3000
    rng = np.random.default_rng(21)
    X = rng.normal(size=(n, 3)).astype(work_dtype)
    tw = getattr(torch, np.dtype(work_dtype).name)
    A = _band_matrix(n, bw=700, seed=11).astype(op_dtype)
    jc = JO.CastOperator(JO.WindowedELLOperator.from_scipy(A), work_dtype)
    tc = CastOperator(WindowedELLOperator.from_scipy(A), tw)
    assert tc.dtype == tw and tc.shape == jc.shape and tc.diagonal() is None
    Xt = torch.as_tensor(X)
    tol = REL if np.float32 in (op_dtype, work_dtype) else REL64_JAX
    for fn in ("matmat", "rmatmat"):
        y = getattr(tc, fn)(Xt).numpy()
        yj = np.asarray(getattr(jc, fn)(jnp.asarray(X)))
        assert y.dtype == yj.dtype == work_dtype
        assert _rel_err(y, yj) <= tol, fn
    shifts = np.array([0.5, -1.0, 2.0])
    y = tc.matmat_shifted(Xt, torch.as_tensor(shifts, dtype=tw)).numpy()
    assert np.array_equal(y, tc.matmat(Xt).numpy())   # no shifted apply
    # the diagonal against a reference operator that has one (its
    # JacobiPrecond does not), the shifted apply against JacobiPrecond
    d = (rng.uniform(3.0, 5.0, n)).astype(op_dtype)
    jd = JO.CastOperator(JO.DenseOperator(np.diag(d[:200])), work_dtype)
    tk = CastOperator(_Jacobi(d), tw)
    assert tk.diagonal().dtype == tw
    assert np.array_equal(tk.diagonal().numpy()[:200],
                          np.asarray(jd.diagonal()))
    jk = JO.CastOperator(JO.JacobiPrecond(jnp.asarray(d)), work_dtype)
    y = tk.matmat_shifted(Xt, torch.as_tensor(shifts, dtype=tw)).numpy()
    yj = np.asarray(jk.matmat_shifted(jnp.asarray(X),
                                      jnp.asarray(shifts, work_dtype)))
    assert y.dtype == yj.dtype == work_dtype
    assert _rel_err(y, yj) <= tol


def test_wrapper_rejects_bad_arguments():
    A = _band_matrix(2048, bw=300, seed=7).astype(np.float32)
    op = WindowedELLOperator.from_scipy(A)
    with pytest.raises(ValueError, match="shape"):
        WE.matmat(op.meta, op.scal, op.offs, op.vals[:, :1], torch.ones(2048, 1))


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    A = _band_matrix(3000, bw=700, seed=2).astype(np.float32)
    op = WindowedELLOperator.from_scipy(A).to("cuda")
    for k in (1, 2, 3, 8, 11):
        X = torch.randn((3000, k), device="cuda")
        before = WE.LAUNCHES
        y = WE.matmat(op.meta, op.scal, op.offs, op.vals, X)
        torch.cuda.synchronize()
        assert WE.LAUNCHES == before + 1
        yref = WE.matmat_reference(op.meta, op.scal, op.offs, op.vals, X)
        assert float((y - yref).abs().max()) <= REL * float(yref.abs().max())


@pytest.mark.cuda
def test_f64_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    A = _band_matrix(3000, bw=700, seed=11)
    op = WindowedELLOperator.from_scipy(A).to("cuda")
    assert op.dtype == torch.float64
    for k in (1, 2, 3, 8, 11):
        X = torch.randn((3000, k), device="cuda", dtype=torch.float64)
        before = dict(WE.KERNEL_LAUNCHES)
        y = WE.matmat(op.meta, op.scal, op.offs, op.vals, X)
        torch.cuda.synchronize()
        assert WE.KERNEL_LAUNCHES == {
            **before, "windowed_ell_spmm_f64":
            before["windowed_ell_spmm_f64"] + 1}
        yref = WE.matmat_reference(op.meta, op.scal, op.offs, op.vals, X)
        # the same f64 sums in the same order; fma rounds once per term
        assert float((y - yref).abs().max()) \
            <= 1e-13 * float(yref.abs().max())
    with pytest.raises(TypeError, match="dtype"):
        WE.matmat(op.meta, op.scal, op.offs, op.vals, X.to(torch.float32))
