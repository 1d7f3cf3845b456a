"""Half-precision operators (f16 and bf16) of the port against the JAX
package on the CPU, on the same seeded numpy inputs carried across by
``primme_tpu_torch/convert.py`` (a bf16 array through the bits of its
``uint16`` view).

Unit parity, the plain versions that the card's kernels are held to:

* stencil, Jacobi (shifted and unshifted, a shift equal to a diagonal
  entry, a zero diagonal entry) and DIA (``matmat`` and ``rmatmat``):
  **bit for bit** against the JAX function computed op by op (every
  operation rounded once to the half type). Under ``jax.jit`` the bf16
  results are the same bit for bit; in f16 XLA's CPU backend, on a CPU
  with native f16 arithmetic, contracts some ``a * b +- c`` into one
  fused operation, so there the bound is two units in the half's last
  place of the sum of the terms' magnitudes for each operation;
* sliced ELL, Dense, BlockELL: the JAX function sums in f32 and rounds
  once to the half type, and so does the port in another order: **within
  one unit in the half's last place** of the result, plus the f32
  rounding of the sum (``w 2**-23 sum |terms|``) where the sum cancels;
* a half operator given a wider (f32 or f64) block computes as the
  reference's products promote: bit for bit (one rounding of the block's
  type per operation) for Jacobi and DIA, within the block type's
  summation bound for the sliced ELL.

Solves, with the gates of ``tests/test_eigsh.py::test_half_precision_basis``
(every true residual, in f64 against the exact matrix, and each value's
distance to the spectrum below ``16 eps(half) ||A||``) and the port's
matvecs within 2x of the JAX package's, on small shapes (8^3, a few
hundred rows); then the refusals that remain, each with its reason.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import primme_tpu
from primme_tpu import operators as JO
from primme_tpu import refine as JR
import primme_tpu_torch as ptt
from primme_tpu_torch import convert as CV
from primme_tpu_torch import refine as TR
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import jacobi as JK
from primme_tpu_torch.ops import stencil3d as ST

HALVES = ["float16", "bfloat16"]
MV_SLACK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eps(half):
    return float(jnp.finfo(jnp.dtype(half)).eps)


def _f32(Y):
    """A JAX or torch array as f32 numpy (exact for a half array)."""
    if isinstance(Y, torch.Tensor):
        return Y.float().numpy()
    return np.asarray(jnp.asarray(Y).astype(jnp.float32))


def _same(a, b):
    """Bit for bit as values: equal, or NaN in both, infinities signed."""
    a, b = _f32(a), _f32(b)
    return a.shape == b.shape and bool(
        np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def _ulp(y, half):
    """One unit in the last place of the half value |y| (the smallest
    normal's where y is subnormal or 0)."""
    fi = jnp.finfo(jnp.dtype(half))
    a = np.maximum(np.abs(y), float(fi.tiny))
    return np.exp2(np.floor(np.log2(a))) * float(fi.eps)


def _block(rng, n, k, half):
    """The same [n, k] half block for both packages: a JAX array, and the
    port's tensor carried across by convert.py."""
    Xj = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32)) \
        .astype(jnp.dtype(half))
    return Xj, CV.block_from_numpy(np.asarray(Xj), "cpu")


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", HALVES)
def test_stencil_plain_matches_reference(half):
    """The 7-point stencil in a half type, and through CastOperator under
    an f32 solve: bit for bit against the JAX function op by op."""
    rng = np.random.default_rng(0)
    nx, ny, nz = 5, 6, 7
    for scale, k in ((0.37, 8),):
        jop = JO.Stencil3DOperator(nx, ny, nz, dtype=jnp.dtype(half),
                                   scale=scale)
        top = CV.stencil_from_jax(jop, device="cpu")
        assert top.dtype == getattr(torch, half)
        Xj, Xt = _block(rng, nx * ny * nz, k, half)
        Yt = top.matmat(Xt)
        assert Yt.dtype == top.dtype
        assert _same(Yt, jop.matmat(Xj))
        # under jit: bf16 as op by op; f16 within the contraction bound
        Yjit = _f32(jax.jit(jop.matmat)(Xj))
        g = np.abs(_f32(Xt))
        mag = scale * 12 * g.max()
        assert np.abs(Yjit - _f32(Yt)).max() <= (
            0 if half == "bfloat16" else 16 * _eps(half) * mag)
        # CastOperator: f32 blocks cast to the half type and back
        X32 = rng.standard_normal((nx * ny * nz, k)).astype(np.float32)
        cj = JO.CastOperator(jop, jnp.float32).matmat(jnp.asarray(X32))
        ct = ptt.CastOperator(top, torch.float32).matmat(torch.tensor(X32))
        assert ct.dtype == torch.float32 and _same(ct, cj)


@pytest.mark.parametrize("half", HALVES)
def test_jacobi_plain_matches_reference(half):
    """Shifted and unshifted Jacobi in a half type, a shift equal to a
    diagonal entry and a zero diagonal entry included: bit for bit against
    the JAX function op by op. In f16 the guard's eps (1e-10) is 0, so that
    denominator stays 0 and the column there is infinite (NaN for a zero
    x); in bf16 it is 1.0e-10 and the guard holds. Through CastOperator the
    f32 shifts round to the half type first; given f32 blocks and shifts
    (a half basis) the apply computes in f32 from the half diagonal."""
    rng = np.random.default_rng(1)
    n, k = 300, 3
    dj = jnp.asarray(rng.uniform(0.5, 4, n).astype(np.float32)).astype(
        jnp.dtype(half))
    dj = dj.at[3].set(0.0)
    jK = JO.JacobiPrecond(dj)
    tK = CV.jacobi_from_jax(jK)
    assert tK.dtype == getattr(torch, half)
    Xj, Xt = _block(rng, n, k, half)
    sj = jnp.stack([dj[5], jnp.asarray(0.3, dj.dtype), dj[7]])
    st = CV.block_from_numpy(np.asarray(sj), "cpu")
    Ys = tK.matmat_shifted(Xt, st)
    assert _same(Ys, jK.matmat_shifted(Xj, sj))
    assert _same(tK.matmat(Xt), jK.matmat(Xj))
    col = _f32(Ys)[5, 0]
    if half == "float16":
        assert np.isinf(col)
    else:
        assert np.isfinite(col) and abs(col) > 1e6
    # CastOperator: the f32 shifts rounded to the half type, as the
    # reference's CastOperator.matmat_shifted rounds them
    s32 = np.asarray([float(sj[0]), 0.3, 1.1], np.float32)
    X32 = rng.standard_normal((n, k)).astype(np.float32)
    cj = JO.CastOperator(jK, jnp.float32).matmat_shifted(
        jnp.asarray(X32), jnp.asarray(s32))
    ct = ptt.CastOperator(tK, torch.float32).matmat_shifted(
        torch.tensor(X32), torch.tensor(s32))
    assert ct.dtype == torch.float32 and _same(ct, cj)
    # a half basis' f32 blocks (and an f64 block): the reference promotes
    for wide in (np.float32, np.float64):
        Xw, sw = X32.astype(wide), s32.astype(wide)
        wj = jK.matmat_shifted(jnp.asarray(Xw), jnp.asarray(sw))
        wt = tK.matmat_shifted(torch.tensor(Xw), torch.tensor(sw))
        assert wt.dtype == torch.tensor(Xw).dtype and _same(wt, wj)
        uj, ut = jK.matmat(jnp.asarray(Xw)), tK.matmat(torch.tensor(Xw))
        assert ut.dtype == wt.dtype and _same(ut, uj)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("half", HALVES)
def test_dia_plain_matches_reference(half, adjoint):
    """The DIA product and its adjoint in a half type: bit for bit against
    the JAX function op by op; given an f32 block, bit for bit in f32 from
    the half values."""
    rng = np.random.default_rng(2)
    n, k, offsets = 200, 3, (0, 1, -1, 5, -7)
    vals = jnp.asarray(rng.standard_normal((len(offsets), n)).astype(
        np.float32)).astype(jnp.dtype(half))
    jop = JO.BandedOperator(offsets, vals)
    top = CV.banded_from_jax(jop)
    assert top.dtype == getattr(torch, half)
    jf = jop.rmatmat if adjoint else jop.matmat
    tf = top.rmatmat if adjoint else top.matmat
    Xj, Xt = _block(rng, n, k, half)
    Yt = tf(Xt)
    assert Yt.dtype == top.dtype and _same(Yt, jf(Xj))
    X32 = rng.standard_normal((n, k)).astype(np.float32)
    for wide in (np.float32, np.float64):
        W = tf(torch.tensor(X32.astype(wide)))
        assert W.dtype == torch.tensor(X32.astype(wide)).dtype
        assert _same(W, jf(jnp.asarray(X32.astype(wide))))


def _sum_bound(Y, terms_abs, w, half):
    """One unit in the half's last place of Y, plus the f32 rounding of a
    sum of ``w`` terms of these magnitudes taken in another order."""
    return _ulp(Y, half) + w * 2.0 ** -23 * terms_abs


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("half", HALVES)
def test_ell_plain_matches_reference(half, adjoint):
    """The sliced-ELL product of a rectangular half ELLOperator (its A and
    A^T layouts) against the reference's einsum (which sums in f32 and
    rounds once, jitted or not): within one unit in the half's last place
    plus f32's summation bound; given an f32 block, within f32's summation
    bound."""
    rng = np.random.default_rng(3)
    m, n, k = 300, 200, 3
    A = sp.random(m, n, density=0.04, random_state=3, format="csr",
                  dtype=np.float32)
    A.data = rng.standard_normal(A.nnz).astype(np.float32)
    cols, vals = JO.ELLOperator._pack(A)
    colsT, valsT = JO.ELLOperator._pack(A.T.tocsr())
    hd = jnp.dtype(half)
    jop = JO.ELLOperator(cols, jnp.asarray(vals).astype(hd), shape=A.shape,
                         colsT=colsT, valsT=jnp.asarray(valsT).astype(hd))
    top = CV.ell_from_jax(jop)
    assert top.dtype == getattr(torch, half) and top.shape == A.shape
    Ah = np.abs(_f32(jnp.asarray(A.toarray()).astype(hd)))
    M, rows = (Ah.T, m) if adjoint else (Ah, n)
    w = int(max(cols.shape[1], colsT.shape[1]))
    Xj, Xt = _block(rng, rows, k, half)
    jf = jop.rmatmat if adjoint else jop.matmat
    tf = top.rmatmat if adjoint else top.matmat
    Yt = tf(Xt)
    assert Yt.dtype == top.dtype
    Yj = _f32(jf(Xj))
    assert np.all(np.abs(Yj - _f32(Yt))
                  <= _sum_bound(Yj, M @ np.abs(_f32(Xt)), w, half))
    X32 = rng.standard_normal((rows, k)).astype(np.float32)
    W = tf(torch.tensor(X32))
    assert W.dtype == torch.float32
    assert np.all(np.abs(_f32(W) - _f32(jf(jnp.asarray(X32))))
                  <= 2 * w * 2.0 ** -24 * (M @ np.abs(X32)))
    X64 = X32.astype(np.float64)
    W = tf(torch.tensor(X64))
    assert W.dtype == torch.float64
    assert np.all(np.abs(W.numpy() - np.asarray(jf(jnp.asarray(X64))))
                  <= 2 * w * 2.0 ** -53 * (M @ np.abs(X64)))


@pytest.mark.parametrize("half", HALVES)
def test_dense_diagonal_block_ell_match_reference(half):
    """The plain-torch half operators (the reference computes them in XLA,
    outside any Pallas kernel): Diagonal bit for bit; Dense and BlockELL
    (f32 sums in another order) within one unit in the half's last place
    plus f32's summation bound."""
    rng = np.random.default_rng(4)
    n, k = 64, 3
    hd = jnp.dtype(half)
    Xj, Xt = _block(rng, n, k, half)
    d = jnp.asarray(rng.standard_normal(n).astype(np.float32)).astype(hd)
    tD = ptt.DiagonalOperator(CV.tensor_from_numpy(d))
    assert _same(tD.matmat(Xt), JO.DiagonalOperator(d).matmat(Xj))
    Ad = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32)) \
        .astype(hd)
    jD = JO.DenseOperator(Ad)
    tDn = CV.dense_from_jax(jD)
    terms = np.abs(_f32(Ad)) @ np.abs(_f32(Xt))
    Yj = _f32(jD.matmat(Xj))
    assert np.all(np.abs(Yj - _f32(tDn.matmat(Xt)))
                  <= _sum_bound(Yj, terms, n, half))
    S = sp.random(n, n, density=0.1, random_state=4, format="csr",
                  dtype=np.float32)
    jb = JO.BlockELLOperator.from_scipy(S, block_size=8,
                                        with_transpose=True)
    jbh = JO.BlockELLOperator(jb.bcols, jb.bvals.astype(hd), jb.shape,
                              jb.bcolsT, jb.bvalsT.astype(hd))
    tb = CV.block_ell_from_jax(jbh)
    assert tb.dtype == getattr(torch, half)
    Sh = np.abs(_f32(jnp.asarray(S.toarray()).astype(hd)))
    for jf, tf, M in ((jbh.matmat, tb.matmat, Sh),
                      (jbh.rmatmat, tb.rmatmat, Sh.T)):
        Yj = _f32(jf(Xj))
        assert np.all(np.abs(Yj - _f32(tf(Xt)))
                      <= _sum_bound(Yj, M @ np.abs(_f32(Xt)), n, half))


def test_ell_from_coo_takes_half_values():
    """``ELLOperator.from_coo`` keeps half values (a numpy f16 array, a
    torch bf16 tensor), repeated entries summed in f32; ``to_dense`` gives
    the matrix in its type."""
    rows, cols = np.array([0, 1, 1, 2, 2]), np.array([0, 1, 1, 2, 0])
    v = np.array([1.5, 0.25, 0.5, -2.0, 3.0], np.float32)
    dense = np.array([[1.5, 0, 0], [0, 0.75, 0], [3.0, 0, -2.0]])
    for vals, dt in ((v.astype(np.float16), torch.float16),
                     (torch.tensor(v).to(torch.bfloat16), torch.bfloat16)):
        op = ptt.ELLOperator.from_coo(rows, cols, vals, (3, 3))
        assert op.dtype == dt and op.diag.dtype == dt
        assert op.to_dense().dtype == dt
        assert np.array_equal(op.to_dense().float().numpy(), dense)


def test_plain_versions_round_each_operation():
    """The stencil, Jacobi and DIA plain versions in a half type equal
    their f32 arithmetic rounded to the half type after every operation
    (the kernels' rule), and the sliced ELL its f32 sum rounded once."""
    rng = np.random.default_rng(5)
    X = torch.tensor(rng.standard_normal((4 * 4 * 4, 2)), dtype=torch.float16)
    r = lambda t: t.to(torch.float16).float()  # noqa: E731
    g = X.float().reshape(4, 4, 4, 2)
    out = r(6 * g)
    for ax in range(3):
        z = torch.zeros_like(g.narrow(ax, 0, 1))
        up = torch.cat([g.narrow(ax, 1, 3), z], dim=ax)
        down = torch.cat([z, g.narrow(ax, 0, 3)], dim=ax)
        out = r(r(out - up) - down)
    assert torch.equal(ST.matmat_reference(X, 4, 4, 4).float(),
                       out.reshape(-1, 2))
    d = torch.tensor(rng.uniform(1, 2, 64), dtype=torch.float16)
    s = torch.tensor([1.25, 0.5], dtype=torch.float16)
    assert torch.equal(JK.shifted_reference(X, d, s, 1e-10).float(),
                       r(X.float() / r(d.float()[:, None] - s.float())))
    assert torch.equal(JK.unshifted_reference(X, d, 1e-10).float(),
                       r(r(1 / d.float())[:, None] * X.float()))
    v = torch.tensor(rng.standard_normal((2, 64)), dtype=torch.float16)
    Y = DK.matmat_reference(v, (0, 1), X).float()
    t0 = r(v[0].float()[:, None] * X.float())
    x1 = torch.cat([X.float()[1:], torch.zeros(1, 2)])
    assert torch.equal(Y, r(t0 + r(v[1].float()[:, None] * x1)))


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def _stencil_spectrum(n):
    lam = 2 - 2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
    return np.sort(np.add.outer(np.add.outer(lam, lam), lam).ravel())


def _laplacian(n):
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1])
    eye = sp.identity(n)
    return (sp.kron(sp.kron(T, eye), eye) + sp.kron(sp.kron(eye, T), eye)
            + sp.kron(sp.kron(eye, eye), T)).tocsr()


def _gates(A, spectrum, vals, vecs, half):
    """The half basis' gates: true residuals (f64, the exact matrix) and
    each value's distance to the spectrum below 16 eps(half) ||A||."""
    anorm = np.abs(spectrum).max()
    floor = 16 * _eps(half) * anorm
    vecs = np.asarray(vecs, np.float64)
    vals = np.asarray(vals, np.float64)
    R = A @ vecs - vecs * vals[None, :]
    assert np.linalg.norm(R, axis=0).max() < floor
    assert np.abs(spectrum[None, :] - vals[:, None]).min(axis=1).max() \
        < floor


def _stencil_case(half, working):
    """An 8^3 stencil with its shift-aware Jacobi: the exact matrix, its
    spectrum, the JAX call and the port's."""
    n = 8
    A = _laplacian(n)
    kw = dict(k=4, which="SA", tol=4 * _eps(half), return_stats=True,
              method="PRIMME_JDQMR_ETol", maxBlockSize=2,
              raise_for_unconverged=False)
    jop = JO.Stencil3DOperator(n, n, n, dtype=jnp.dtype(half))
    top = CV.stencil_from_jax(jop, device="cpu")

    def run_jax():
        return primme_tpu.eigsh(
            jop, OPinv=JO.JacobiPrecond(jop.diagonal()),
            dtype=None if working is None else jnp.dtype(working), **kw)

    def run_port():
        return ptt.eigsh(
            top, OPinv=ptt.JacobiPrecond(top.diagonal()),
            dtype=None if working is None else getattr(torch, working),
            device="cpu", **kw)
    return A, _stencil_spectrum(n), run_jax, run_port


def _sparse_case(fmt):
    """A 400-row tridiagonal BandedOperator in bf16 or a 400-row symmetric
    ELLOperator in f16 (entries exact in the half type), each under an f32
    solve."""
    n = 400
    half = "bfloat16" if fmt == "banded" else "float16"
    hd = jnp.dtype(half)
    if fmt == "banded":
        A = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                     [-1, 0, 1]).tocsr()
        spectrum = 2 - 2 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
        D = sp.dia_matrix(A)
        jop = JO.BandedOperator.from_scipy(D)
        jop = JO.BandedOperator(jop.offsets, jop.vals.astype(hd), jop.shape)
        top = CV.banded_from_jax(jop)
        which = "LA"
    else:
        rng = np.random.default_rng(6)
        B = sp.random(n, n, density=0.01, random_state=6, format="csr")
        B.data = np.round(rng.uniform(-4, 4, B.nnz)) / 4
        A = (B + B.T + sp.diags(np.arange(n) / 40.0)).tocsr()
        A.data = A.data.astype(np.float16).astype(np.float64)
        spectrum = np.linalg.eigvalsh(A.toarray())
        cols, vals = JO.ELLOperator._pack(A)
        jop = JO.ELLOperator(cols, jnp.asarray(vals).astype(hd))
        top = CV.ell_from_jax(jop)
        which = "SA"
    assert top.dtype == getattr(torch, half)
    kw = dict(k=3, which=which, tol=4 * _eps(half), return_stats=True,
              raise_for_unconverged=False)
    return (A, spectrum, half,
            lambda: primme_tpu.eigsh(jop, dtype=jnp.float32, **kw),
            lambda: ptt.eigsh(top, dtype=torch.float32, device="cpu", **kw))


def _svds_case():
    """svds(k=3, LM) of a 240 x 120 f16 ELLOperator at ``tol = 4 eps(f16)``
    on the normal equations (a half basis over ``A^T A``)."""
    hd = jnp.float16
    rng = np.random.default_rng(7)
    A = sp.random(240, 120, density=0.05, random_state=7, format="csr")
    A.data = np.round(rng.uniform(0.125, 8, A.nnz) * 8) / 8
    cols, vals = JO.ELLOperator._pack(A)
    colsT, valsT = JO.ELLOperator._pack(A.T.tocsr())
    jop = JO.ELLOperator(cols, jnp.asarray(vals).astype(hd), shape=A.shape,
                         colsT=colsT, valsT=jnp.asarray(valsT).astype(hd))
    top = CV.ell_from_jax(jop)
    kw = dict(k=3, which="LM", tol=4 * _eps("float16"), return_stats=True,
              raise_for_unconverged=False, method="normalequations")
    return (A, lambda: primme_tpu.svds(jop, **kw),
            lambda: ptt.svds(top, device="cpu", **kw))


STENCIL_SOLVES = [("float16", "float32"), ("bfloat16", None)]
SPARSE_SOLVES = ["banded", "ell"]


@pytest.fixture(scope="module", autouse=True)
def jax_solves():
    """The JAX package's five reference solves of this file, started side
    by side in threads when the module's first test starts (each compiles
    its own program, and XLA releases the interpreter while it compiles,
    so the compiles overlap each other and the unit tests): name -> a
    future of the solve's result, which raises what the solve raised."""
    calls = {("stencil", h, w): _stencil_case(h, w)[2]
             for h, w in STENCIL_SOLVES}
    calls.update({("sparse", f): _sparse_case(f)[3] for f in SPARSE_SOLVES})
    calls[("svds",)] = _svds_case()[1]
    pool = ThreadPoolExecutor(len(calls))
    futures = {name: pool.submit(fn) for name, fn in calls.items()}
    pool.shutdown(wait=False)
    yield futures
    for f in futures.values():
        f.result()


@pytest.mark.parametrize("half, working", STENCIL_SOLVES)
def test_stencil_jacobi_solve_matches_reference(half, working, jax_solves):
    """An 8^3 stencil with its shift-aware Jacobi: f16 under an f32 solve
    (CastOperator around both), and bf16 with ``dtype=None`` (a half basis
    over the half operator), through both packages."""
    A, spectrum, _, run_port = _stencil_case(half, working)
    wt, Vt, st = run_port()
    wj, Vj, sj = jax_solves[("stencil", half, working)].result()
    for vals, vecs in ((wt, Vt), (wj, Vj)):
        _gates(A, spectrum, vals, vecs, half)
    assert st["num_matvecs"] <= MV_SLACK * sj["num_matvecs"]
    if working is not None:
        assert st["probe_verified"] and not st["probe_exhausted"]


@pytest.mark.parametrize("fmt", SPARSE_SOLVES)
def test_sparse_half_solve_matches_reference(fmt, jax_solves):
    """A 400-row tridiagonal BandedOperator in bf16 and a 400-row symmetric
    ELLOperator in f16 (entries exact in the half type), each under an f32
    solve, through both packages."""
    A, spectrum, half, _, run_port = _sparse_case(fmt)
    wt, Vt, st = run_port()
    wj, Vj, sj = jax_solves[("sparse", fmt)].result()
    for vals_, vecs in ((wt, Vt), (wj, Vj)):
        _gates(A, spectrum, vals_, vecs, half)
    assert st["num_matvecs"] <= MV_SLACK * sj["num_matvecs"]
    assert st["probe_verified"] and not st["probe_exhausted"]


def test_svds_of_half_ell_matches_reference(jax_solves):
    """svds(k=3, LM) of a 240 x 120 f16 ELLOperator at ``tol = 4
    eps(f16)`` on the normal equations (a half basis over ``A^T A``)
    through both packages: singular values and triplet residuals (f64,
    the exact matrix) below ``16 eps(f16) ||A||``, and the matvecs within
    2x of the JAX package's."""
    A, _, run_port = _svds_case()
    sv = np.linalg.svd(A.toarray(), compute_uv=False)
    Ut, s_t, Vht, stt = run_port()
    Uj, sj, Vhj, stj = jax_solves[("svds",)].result()
    floor = 16 * _eps("float16") * sv[0]
    for U, s, Vh in ((Ut, s_t, Vht), (Uj, sj, Vhj)):
        U, s, V = (np.asarray(x, np.float64) for x in (U, s, np.asarray(
            Vh).T))
        assert np.abs(np.sort(s)[::-1] - sv[:3]).max() < floor
        res = np.hypot(np.linalg.norm(A @ V - U * s, axis=0),
                       np.linalg.norm(A.T @ U - V * s, axis=0))
        assert res.max() < floor

    def mv(st):
        return st.get("stage1_num_matvecs", 0) + st.get(
            "stage2_num_matvecs", 0)
    assert mv(stt) <= MV_SLACK * mv(stj)


def test_refine_takes_a_half_operator():
    """``refine_eigsh`` casts a half operator's products to f64, as the
    reference's does (``primme_tpu/refine.py:75-82``): from the same f32
    start both packages polish an f16 8^3 stencil's four smallest pairs to
    within the half operator's own floor of the closed form."""
    n = 8
    spectrum = _stencil_spectrum(n)
    A = _laplacian(n)
    w, V = np.linalg.eigh(A.toarray())
    X0 = (V[:, :4] + 1e-3 * np.random.default_rng(8).standard_normal(
        (n ** 3, 4))).astype(np.float32)
    jop = JO.Stencil3DOperator(n, n, n, dtype=jnp.float16)
    top = CV.stencil_from_jax(jop, device="cpu")
    kw = dict(tol=1e-3, which="SA", maxiter=40)
    wj, Vj = JR.refine_eigsh(jop, X0, device="cpu", **kw)
    wt, Vt = TR.refine_eigsh(top, X0, device="cpu", **kw)
    floor = 16 * _eps("float16") * spectrum.max()
    for vals in (wt, wj):
        assert np.abs(np.sort(np.asarray(vals)) - spectrum[:4]).max() < floor
    assert np.abs(np.sort(wt) - np.sort(np.asarray(wj))).max() < floor


# ---------------------------------------------------------------------------
# what stays refused, each by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", HALVES)
def test_half_refusals_name_their_reason(half):
    """A complex block or complex shifts on a half operator and a complex
    working type over one (no complex half type; the reference's cast
    drops the imaginary part: Queue C6); a half ELLOperator from a scipy
    matrix (scipy holds none: from_coo takes half values). A half operator
    under a mesh is served (it was refused until its sharded forms were
    held to the JAX package's, ``tests/test_torch_sharded_half.py``):
    ``shard_operator`` splits a half stencil over x-planes in its type,
    and a cast around one keeps the cast around the split stencil."""
    dt = getattr(torch, half)
    op = ptt.Stencil3DOperator(4, 4, 4, dtype=dt, device="cpu")
    K = ptt.JacobiPrecond(op.diagonal())
    Xc = torch.ones((64, 2), dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="C6"):
        op.matmat(Xc)
    with pytest.raises(NotImplementedError, match="C6"):
        K.matmat_shifted(torch.ones((64, 2), dtype=dt),
                         torch.ones(2, dtype=torch.complex64))
    with pytest.raises(NotImplementedError, match="C6"):
        ptt.CastOperator(op, torch.complex64)
    with pytest.raises(NotImplementedError, match="from_coo"):
        ptt.ELLOperator.from_scipy(sp.identity(10, dtype=np.float16))
    from types import SimpleNamespace
    from primme_tpu_torch import distributed as D
    # what shard_operator reads of a 2-rank partition of the 64 rows
    comm = SimpleNamespace(size=2, rank=0, n=64, nl=32, lo=0, hi=32)
    sop = D.shard_operator(op, comm)
    assert isinstance(sop, D.ShardedStencil3D) and sop.dtype == dt
    assert sop.planes == 2 and sop.diagonal().dtype == dt
    cop = D.shard_operator(ptt.CastOperator(op, torch.float32), comm)
    assert isinstance(cop, ptt.CastOperator) and cop.dtype == torch.float32
    assert isinstance(cop.op, D.ShardedStencil3D) and cop.op.dtype == dt
