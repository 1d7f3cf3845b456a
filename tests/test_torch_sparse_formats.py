"""The port's sparse formats and format chooser against the JAX package's
on the same numpy inputs, on the CPU (where each product runs its plain
version): the CSR -> sliced-ELL layout (``from_csr``, square and
rectangular), ``ELLOperator`` (square and rectangular),
the DIA+ELL hybrid ``SumOperator``, ``BlockELLOperator``, ``FunctionOperator`` over a
scipy ``LinearOperator``, the chooser's choice on every fixture of
``tests/test_operators.py`` and ``tests/test_eigsh.py``, and ``eigsh``
through each branch.

Tolerances: a sparse product sums a row in another order than the
reference's einsum, so it is held to 8 eps(dtype) w max|A| max|X| (w the
longest row); diagonals and the chooser's choices are exact; eigenvalues
against scipy as the reference's own tests hold them, and matvec counts
within ``MV_SLACK`` of the reference's."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

import primme_tpu
from primme_tpu import operators as JO
import primme_tpu_torch as ptt
from primme_tpu_torch import convert as CV
from primme_tpu_torch.ops import windowed_ell as WE
from test_operators import _fem_like, _tridiag_plus_scatter
from test_torch_problems import laplacian27_permuted

DTYPES = [np.float32, np.float64]
MV_SLACK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # beside parallel test workers, extra intra-op threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tridiag():
    """``tests/test_eigsh.py``'s fixture."""
    n = 300
    d = np.linspace(1, 100, n)
    return sp.diags([d, 0.3 * np.ones(n - 1), 0.3 * np.ones(n - 1)],
                    [0, 1, -1]).tocsr()


def _random(n=3000, seed=5):
    """A random symmetric matrix no format but ELL takes."""
    S = sp.random(n, n, density=4.0 / n, random_state=seed)
    return (sp.diags(np.arange(n, dtype=np.float64)) + S + S.T).tocsr()


def _tol(A, X, dtype):
    w = max(int(np.diff(sp.csr_matrix(A).indptr).max()), 1)
    return 8 * np.finfo(dtype).eps * w * abs(A).max() * np.abs(X).max()


def _t(X):
    return torch.as_tensor(np.ascontiguousarray(X))


# --- the CSR -> sliced-ELL layout ------------------------------------------

def _holes(n=200, seed=0):
    """Rows 32-95 and the last 8 empty (three whole slices of width 0), one
    row much longer than the rest, explicit zeros; n not a multiple of
    32."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.05, random_state=seed, format="lil")
    A[32:96, :] = 0
    A[n - 8:, :] = 0
    A[5, :] = rng.normal(size=n)
    A[7, 3] = 0.0
    A = A.tocsr()
    A.data[A.indices == 3] = 0.0                 # explicit zeros stay
    return A


@pytest.mark.parametrize("dtype", DTYPES)
def test_from_csr_layout(dtype):
    A = _holes()
    lay = WE.from_csr(A, dtype)
    n = A.shape[0]
    assert np.array_equal(lay.rowlen, np.diff(A.indptr))
    width = np.diff(lay.slice_ptr) // WE.SLICE
    padded = np.zeros(-(-n // WE.SLICE) * WE.SLICE, np.int64)
    padded[:n] = lay.rowlen
    assert np.array_equal(width, padded.reshape(-1, WE.SLICE).max(axis=1))
    assert (width == 0).sum() == 3 and lay.vals.dtype == dtype
    # entry j of row r is its j-th CSR entry, at slice_ptr[r//32] + 32j + r%32
    for r in range(n):
        lo, hi = A.indptr[r], A.indptr[r + 1]
        pos = lay.slice_ptr[r // 32] + 32 * np.arange(hi - lo) + r % 32
        assert np.array_equal(lay.cols[pos], A.indices[lo:hi])
        assert np.array_equal(lay.vals[pos], A.data[lo:hi].astype(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3])
def test_from_csr_product(k, dtype):
    A = _holes().astype(dtype)
    X = np.random.default_rng(k).normal(size=(A.shape[0], k)).astype(dtype)
    lay = WE.from_csr(A, dtype)
    y = WE.matmat(*(torch.as_tensor(a) for a in lay), _t(X)).numpy()
    assert y.dtype == dtype
    assert np.abs(y - A @ X).max() <= _tol(A, X, dtype)
    # a matrix of empty rows only, and one with no rows
    for Z in (sp.csr_matrix((70, 70), dtype=dtype),
              sp.csr_matrix((0, 0), dtype=dtype)):
        lay = WE.from_csr(Z, dtype)
        assert len(lay.cols) == 0
        out = WE.matmat(*(torch.as_tensor(a) for a in lay), torch.ones(
            (Z.shape[0], k), dtype=getattr(torch, np.dtype(dtype).name)))
        assert out.shape == (Z.shape[0], k) and not out.any()


def _rect_holes(m, n, seed=0):
    """An m x n matrix with empty rows (a whole slice among them), empty
    columns and an explicit zero."""
    A = sp.random(m, n, density=0.08, random_state=seed, format="lil")
    A[32:64, :] = 0
    A[:, 3:9] = 0
    A = A.tocsr()
    A.data[A.indices == 10] = 0.0                # explicit zeros stay
    return A


RECT_SHAPES = [(333, 70), (45, 290)]             # m > n and m < n


def test_from_csr_refuses_rectangular():
    """Once refused, a rectangular matrix is now laid out: ceil(m/32)
    slices of its m rows, the columns as they are; the product takes an
    [n, k] block to [m, k] (m > n and m < n, f32 and f64), and a block of
    the wrong height is refused."""
    for (m, n), dtype in zip(RECT_SHAPES * 2, DTYPES * 2):
        A = _rect_holes(m, n).astype(dtype)
        lay = WE.from_csr(A, dtype)
        assert len(lay.slice_ptr) == -(-m // WE.SLICE) + 1
        assert np.array_equal(lay.rowlen, np.diff(A.indptr))
        assert len(lay.cols) == 0 or lay.cols.max() < n
        for r in range(m):
            lo, hi = A.indptr[r], A.indptr[r + 1]
            pos = lay.slice_ptr[r // 32] + 32 * np.arange(hi - lo) + r % 32
            assert np.array_equal(lay.cols[pos], A.indices[lo:hi])
        X = np.random.default_rng(m).normal(size=(n, 3)).astype(dtype)
        arrays = [torch.as_tensor(a) for a in lay]
        y = WE.matmat(*arrays, _t(X), n).numpy()
        assert y.shape == (m, 3) and y.dtype == dtype
        assert np.abs(y - A @ X).max() <= _tol(A, X, dtype)
        with pytest.raises(ValueError, match="is not"):
            WE.matmat(*arrays, _t(X[:-1]), n)


# --- ELLOperator -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3])
def test_ell_operator_matches_reference(k, dtype):
    # a non-symmetric matrix, so that rmatmat's own layout counts
    A = (_tridiag_plus_scatter() + sp.random(2500, 2500, density=1e-3,
                                             random_state=9)).tocsr()
    A = A.astype(dtype)
    X = np.random.default_rng(k).normal(size=(A.shape[0], k)).astype(dtype)
    jop, top = JO.ELLOperator.from_scipy(A), ptt.ELLOperator.from_scipy(A)
    assert top.shape == jop.shape and top.dtype == getattr(
        torch, np.dtype(dtype).name)
    for fn, M in (("matmat", A), ("rmatmat", A.T)):
        y = getattr(top, fn)(_t(X)).numpy()
        yj = np.asarray(getattr(jop, fn)(jnp.asarray(X)))
        assert np.abs(y - yj).max() <= _tol(M, X, dtype), fn
    assert np.array_equal(top.diagonal().numpy(), np.asarray(jop.diagonal()))
    # the converted reference operator is the same operator
    conv = CV.ell_from_jax(jop)
    for name in ("slice_ptr", "rowlen", "cols", "vals"):
        assert torch.equal(getattr(conv, name), getattr(top, name)), name


def test_ell_operator_refuses():
    """A rectangular matrix, once refused, keeps its shape (its products
    on the A and A^T layouts, the reference's diagonal); complex values
    are served (``tests/test_torch_complex.py``), half precision is
    refused."""
    A = sp.random(9000, 10, density=0.1, random_state=0).tocsr()
    top, jop = ptt.ELLOperator.from_scipy(A), JO.ELLOperator.from_scipy(A)
    assert top.shape == jop.shape == (9000, 10)
    X, Y = (np.random.default_rng(0).normal(size=(r, 2)) for r in (10, 9000))
    assert np.abs(top.matmat(_t(X)).numpy()
                  - np.asarray(jop.matmat(jnp.asarray(X)))).max() \
        <= _tol(A, X, np.float64)
    assert np.abs(top.rmatmat(_t(Y)).numpy()
                  - np.asarray(jop.rmatmat(jnp.asarray(Y)))).max() \
        <= _tol(A.T, Y, np.float64)
    assert np.array_equal(top.diagonal().numpy(), np.asarray(jop.diagonal()))
    assert ptt.ELLOperator.from_scipy(
        sp.identity(10, dtype=np.complex128)).dtype == torch.complex128
    with pytest.raises(NotImplementedError, match="ELLOperator"):
        ptt.ELLOperator.from_scipy(sp.identity(10, dtype=np.float16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RECT_SHAPES)
def test_rectangular_ell_operator_matches_reference(shape, dtype):
    """An m x n ELLOperator against the JAX package's (its colsT/valsT
    layout for rmatmat) and scipy, with empty rows and columns: matmat
    [n, k] -> [m, k], rmatmat [m, k] -> [n, k], the diagonal of length m
    (0 past column n), and ``ell_from_jax`` carrying the reference's
    rectangular operator across."""
    m, n = shape
    A = _rect_holes(m, n, seed=1).astype(dtype)
    top, jop = ptt.ELLOperator.from_scipy(A), JO.ELLOperator.from_scipy(A)
    assert top.shape == jop.shape == (m, n)
    rng = np.random.default_rng(2)
    X, Y = (rng.normal(size=(r, 3)).astype(dtype) for r in (n, m))
    for fn, Z, M in (("matmat", X, A), ("rmatmat", Y, A.T)):
        y = getattr(top, fn)(_t(Z)).numpy()
        assert y.shape == (M.shape[0], 3) and y.dtype == dtype, fn
        assert np.abs(y - M @ Z).max() <= _tol(M, Z, dtype), fn
        yj = np.asarray(getattr(jop, fn)(jnp.asarray(Z)))
        assert np.abs(y - yj).max() <= _tol(M, Z, dtype), fn
    d = top.diagonal().numpy()
    assert d.shape == (m,) and np.array_equal(d, np.asarray(jop.diagonal()))
    # the conversion drops zero values (the reference's padding), the
    # explicit zero among them
    conv = CV.ell_from_jax(jop)
    Az = A.copy()
    Az.eliminate_zeros()
    tz = ptt.ELLOperator.from_scipy(Az)
    assert conv.shape == (m, n)
    for name in ("slice_ptr", "rowlen", "cols", "vals", "slice_ptr_t",
                 "rowlen_t", "cols_t", "vals_t"):
        assert torch.equal(getattr(conv, name), getattr(tz, name)), name
    with pytest.raises(ValueError, match="is not"):
        top.matmat(_t(Y))


def test_aslinearoperator_densify_rule_on_rectangular_input():
    """The reference's rule for sparse input, rectangular too: dense up to
    8192 rows and columns (and 256 MB), else an ELLOperator of the same
    shape."""
    for shape in ((8192, 40), (40, 8192), (8193, 40), (40, 8193)):
        A = sp.random(*shape, density=0.01, random_state=0).tocsr()
        top, jop = ptt.aslinearoperator(A), JO.aslinearoperator(A)
        assert type(top).__name__ == type(jop).__name__, shape
        assert top.shape == tuple(jop.shape) == shape
        assert isinstance(top, ptt.DenseOperator) == (max(shape) <= 8192)


def test_svds_without_device_needs_a_card(monkeypatch):
    # svds, like eigsh, runs on the card unless asked otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _rect_holes(333, 70).tocsr()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ptt.svds(A, k=2, tol=1e-8)
    s = ptt.svds(A, k=2, tol=1e-8, device="cpu",
                 return_singular_vectors=False)
    ref = np.linalg.svd(A.toarray(), compute_uv=False)[:2]
    assert np.abs(np.sort(s)[::-1] - ref).max() <= 1e-7 * ref[0]


# --- the DIA+ELL hybrid ------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_ell_hybrid_matches_reference(dtype):
    A = _tridiag_plus_scatter().astype(dtype)
    jh, th = JO.dia_ell_hybrid(A), ptt.dia_ell_hybrid(A)
    assert isinstance(th, ptt.SumOperator)
    assert [type(o).__name__ for o in th.ops] == \
        [type(o).__name__ for o in jh.ops] == ["BandedOperator", "ELLOperator"]
    assert th.ops[0].offsets == jh.ops[0].offsets
    assert np.array_equal(th.ops[0].vals.numpy(), np.asarray(jh.ops[0].vals))
    X = np.random.default_rng(0).normal(size=(A.shape[0], 4)).astype(dtype)
    for fn in ("matmat", "rmatmat"):
        y = getattr(th, fn)(_t(X)).numpy()
        assert np.abs(y - np.asarray(getattr(jh, fn)(jnp.asarray(X)))).max() \
            <= _tol(A, X, dtype), fn
        assert np.abs(y - A @ X).max() <= _tol(A, X, dtype), fn
    assert np.array_equal(th.diagonal().numpy(), np.asarray(jh.diagonal()))
    assert np.array_equal(th.diagonal().numpy(), A.diagonal())
    conv = CV.sum_from_jax(jh)
    assert torch.equal(conv.matmat(_t(X)), th.matmat(_t(X)))


def test_dia_ell_hybrid_declines_like_the_reference():
    # too little coverage, a pure band (no remainder), too many diagonals
    for A, kw in ((_random(), {}), (_tridiag(), {}),
                  (_tridiag_plus_scatter(), {"max_diags": 2})):
        jh, th = JO.dia_ell_hybrid(A, **kw), ptt.dia_ell_hybrid(A, **kw)
        assert type(th).__name__ == type(jh).__name__


# --- BlockELL ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_block_ell_matches_reference(dtype):
    A = _fem_like().astype(dtype)
    jop = JO.BlockELLOperator.from_scipy(A, block_size=8, with_transpose=True)
    top = ptt.BlockELLOperator.from_scipy(A, block_size=8,
                                          with_transpose=True)
    X = np.random.default_rng(0).normal(size=(A.shape[0], 5)).astype(dtype)
    tol = 8 * np.finfo(dtype).eps * 48 * abs(A).max() * np.abs(X).max()
    for fn, M in (("matmat", A), ("rmatmat", A.T)):
        y = getattr(top, fn)(_t(X)).numpy()
        assert np.abs(y - np.asarray(getattr(jop, fn)(jnp.asarray(X)))).max() \
            <= tol, fn
        assert np.abs(y - M @ X).max() <= tol, fn
    assert np.abs(top.diagonal().numpy() - np.asarray(jop.diagonal())).max() \
        <= 8 * np.finfo(dtype).eps * abs(A).max()
    conv = CV.block_ell_from_jax(jop)
    assert torch.equal(conv.matmat(_t(X)), top.matmat(_t(X)))


def test_block_ell_unaligned_and_rect():
    rng = np.random.default_rng(1)
    A = sp.random(205, 117, density=0.05, random_state=2).tocsr()
    jop = JO.BlockELLOperator.from_scipy(A, block_size=8)
    top = ptt.BlockELLOperator.from_scipy(A, block_size=8)
    X, Y = rng.normal(size=(117, 3)), rng.normal(size=(205, 3))
    for fn, Z, M in (("matmat", X, A), ("rmatmat", Y, A.T)):
        y = getattr(top, fn)(_t(Z)).numpy()
        assert np.abs(y - M @ Z).max() < 1e-12
        assert np.abs(y - np.asarray(getattr(jop, fn)(jnp.asarray(Z)))).max() \
            < 1e-12


# --- FunctionOperator --------------------------------------------------------

def test_function_operator_runs_on_the_host():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(40, 40))
    L = spla.aslinearoperator(M)
    op = ptt.aslinearoperator(L)
    assert isinstance(op, ptt.FunctionOperator) and op.dtype == torch.float64
    assert op.device == torch.device("cpu") and op.diagonal() is None
    X = rng.normal(size=(40, 3))
    y = op.matmat(_t(X))
    assert y.dtype == torch.float64 and y.device == op.device
    assert np.abs(y.numpy() - M @ X).max() <= 1e-12
    assert np.abs(op.rmatmat(_t(X)).numpy() - M.T @ X).max() <= 1e-12
    jop = JO.aslinearoperator(L)
    assert np.abs(y.numpy() - np.asarray(jop.matmat(jnp.asarray(X)))).max() \
        <= 1e-12


def test_eigsh_through_a_scipy_linear_operator():
    A = _tridiag()
    L = spla.LinearOperator(A.shape, matvec=lambda x: A @ x,
                            matmat=lambda X: A @ X, dtype=np.float64)
    w = ptt.eigsh(L, k=4, which="SA", tol=1e-9, device="cpu",
                  return_eigenvectors=False)
    ref = np.linalg.eigvalsh(A.toarray())[:4]
    assert np.abs(np.sort(w) - ref).max() < 1e-7 * 100


# --- the chooser -------------------------------------------------------------

CHOOSER_CASES = {
    "tridiag": (_tridiag, {}),
    "tridiag_plus_scatter": (_tridiag_plus_scatter, {}),
    "fem_like": (_fem_like, {}),
    "fem_like_forced": (lambda: _fem_like(n=4000),
                        {"max_diags": 8, "fill_factor": 1.0}),
    "laplacian27_permuted": (lambda: laplacian27_permuted(16)[0], {}),
    "random": (_random, {}),
    "dense_fallback": (lambda: sp.random(500, 500, density=0.01,
                                         random_state=0).tocsr(), {}),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CHOOSER_CASES))
def test_chooser_takes_the_reference_branch(case, dtype):
    make, kw = CHOOSER_CASES[case]
    A = make().astype(dtype)
    jr, tr = JO.rcm_banded(A, **kw), ptt.rcm_banded(A, **kw)
    assert (jr is None) == (tr is None)
    if jr is None:
        # aslinearoperator's branch: dense below 8192 rows, else ELL
        jop, top = JO.aslinearoperator(A), ptt.aslinearoperator(A)
        assert type(top).__name__ == type(jop).__name__
        return
    (jop, jperm), (top, tperm) = jr, tr
    assert type(top).__name__ == type(jop).__name__
    assert (tperm is None) == (jperm is None)
    if jperm is not None:
        assert np.array_equal(tperm, jperm)
    assert top.dtype == getattr(torch, np.dtype(dtype).name)
    # the port's operator is P A P^T (the reference's products are held
    # against the port's format by format above)
    X = np.random.default_rng(0).normal(size=(A.shape[0], 2)).astype(dtype)
    Ap = A if tperm is None else A[tperm][:, tperm]
    assert np.abs(top.matmat(_t(X)).numpy() - Ap @ X).max() \
        <= 8 * _tol(Ap, X, dtype)


# --- eigsh through each branch -----------------------------------------------

EIGSH_CASES = {
    # (matrix, eigsh arguments, reference eigenvalues tolerance)
    "tridiag": (_tridiag, dict(k=5, which="SA", tol=1e-9,
                               method="PRIMME_GD_Olsen_plusK"), 1e-5),
    "hybrid": (_tridiag_plus_scatter,
               dict(k=3, which="SA", tol=1e-8, maxMatvecs=4000), 1e-6),
    "block_ell": (lambda: _fem_like(n=1600) + sp.eye(1600) * 50.0,
                  dict(k=3, which="LA", tol=1e-8, maxMatvecs=6000), 1e-6),
}


@pytest.mark.parametrize("case", sorted(EIGSH_CASES))
def test_eigsh_through_each_branch(case):
    make, kw, ev_tol = EIGSH_CASES[case]
    A = make().tocsr()
    w, V, st = ptt.eigsh(A, return_stats=True, device="cpu",
                         raise_for_unconverged=False, **kw)
    wj, _, stj = primme_tpu.eigsh(A, return_stats=True,
                                  raise_for_unconverged=False, **kw)
    tru = np.sort(spla.eigsh(A, k=kw["k"], which=kw["which"],
                             return_eigenvectors=False))
    assert np.abs(np.sort(w) - tru).max() < ev_tol
    assert np.abs(np.sort(np.asarray(wj)) - tru).max() < ev_tol
    R = A @ V - V * w[None, :]
    anorm = abs(A).sum(axis=1).max()          # >= ||A||
    assert np.linalg.norm(R, axis=0).max() <= 10 * kw["tol"] * anorm
    mv, mvj = st["num_matvecs"], int(stj["num_matvecs"])
    assert mvj / MV_SLACK <= mv <= MV_SLACK * mvj, (mv, mvj)


def test_stats_parity_on_the_tridiag_fixture():
    """``tests/test_eigsh.py::test_stats_parity``'s assertions (without
    the time breakdown) on the port: the comm-volume counters, the dense
    flops, the ortho inner products, no broadcast, the range estimates."""
    A = _tridiag()
    ref = np.linalg.eigvalsh(A.toarray())
    vals, _, st = ptt.eigsh(A, k=4, which="SA", tol=1e-9, jacobi=True,
                            return_stats=True, raise_for_unconverged=False,
                            device="cpu")
    assert st["num_global_sum"] > 0
    assert st["volume_global_sum"] >= st["num_global_sum"]
    assert st["flops_dense"] > 0 and st["num_ortho_inner_prods"] > 0
    assert st["num_broadcast"] == 0 and st["volume_broadcast"] == 0
    assert st["est_min_eval"] <= vals.min() + 1e-6
    assert st["est_max_eval"] >= vals.max() - 1e-6
    assert st["est_max_eval"] <= ref.max() + 1.0
    # the same counts as the reference's on the same solve, to the
    # solve's own spread (both run the same analytic formulas per event)
    _, _, stj = primme_tpu.eigsh(A, k=4, which="SA", tol=1e-9, jacobi=True,
                                 return_stats=True,
                                 raise_for_unconverged=False)
    for key in ("num_global_sum", "volume_global_sum", "flops_dense",
                "num_ortho_inner_prods"):
        assert stj[key] / MV_SLACK <= st[key] <= MV_SLACK * stj[key], key
