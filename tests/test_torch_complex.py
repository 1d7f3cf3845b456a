"""Complex input in the port against the JAX package on the same numpy
inputs, on the CPU: every complex operator's ``matmat`` and ``rmatmat``
(``A^H``) through ``convert.*_from_jax``, the DIA and sliced-ELL plain
versions against scipy, the dense numerics (``gram``, ``block_ortho``,
``projected_eigh``, ``compute_residuals``) and the JDQMR inner solve on
complex blocks, a real operator's product of a complex block (both parts,
where the operators once dropped the imaginary one), the complex random
block, the working-type rules and ``eigsh`` on
``tests/test_eigsh.py::test_complex_hermitian``'s fixture. The solves on
the magnetic Laplacian, the complex scatter and ``svds`` are in
``test_torch_complex_solves.py``.

Tolerances, relative to the result's largest entry: 1e-5 for complex64
and 1e-13 for complex128 (sums in another order over at most a few dozen
terms a row; the DIA plain version equals the reference's loop up to the
order of a complex product's two roundings); the dense numerics 1e-12 in
complex128 as ``test_torch_linalg.py`` holds f64; the inner solve 1e-9 as
``test_torch_inner.py`` does; eigenvalues to the fixture's own bar."""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp

import primme_tpu
import primme_tpu_torch as ptt
from primme_tpu import operators as JO
from primme_tpu import params as jp
from primme_tpu.core import inner as ji
from primme_tpu.core import linalg as jl
from primme_tpu.core import solver as js
from primme_tpu_torch import convert as CV
from primme_tpu_torch.convert import params_from_jax
from primme_tpu_torch.core import inner as ti
from primme_tpu_torch.core import linalg as tl
from primme_tpu_torch.core import solver as ts
from primme_tpu_torch.ops import dia as DK
from primme_tpu_torch.ops import windowed_ell as WE

CTYPES = [np.complex64, np.complex128]
REL = {np.dtype(np.complex64): 1e-5, np.dtype(np.complex128): 1e-13,
       np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-13}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # beside parallel test workers, extra intra-op threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) or 1.0     # an expected zero block: absolute
    err = float(np.abs(a.astype(np.complex128) - b.astype(np.complex128)).max())
    assert err <= rel * scale, (err, rel * scale)


def _crand(rng, shape, dtype=np.complex128):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)


def _hermitian_sparse(n, density, seed, dtype):
    A = sp.random(n, n, density=density, random_state=seed, format="csr")
    B = sp.random(n, n, density=density, random_state=seed + 1, format="csr")
    C = A + 1j * B
    return (C + C.conj().T + sp.diags(np.arange(n, dtype=float))).tocsr() \
        .astype(dtype)


def _banded_complex(n, dtype):
    """A complex Hermitian band, unsorted offsets past the middle."""
    rng = np.random.default_rng(5)
    offs = (0, 1, 7, n // 2 + 3)
    A = sp.diags([rng.normal(size=n)], [0], shape=(n, n), dtype=complex)
    for o in offs[1:]:
        d = rng.normal(size=n - o) + 1j * rng.normal(size=n - o)
        A = A + sp.diags([d, d.conj()], [o, -o], shape=(n, n))
    return A.tocsr().astype(dtype)


def _ops(dtype):
    """(name, the JAX package's operator, the port's through convert, the
    scipy matrix) of every complex format."""
    n = 300
    band = _banded_complex(n, dtype)
    scat = _hermitian_sparse(n, 0.02, 1, dtype)
    rect = (sp.random(n, 170, density=0.05, random_state=4, format="csr")
            + 1j * sp.random(n, 170, density=0.05, random_state=5,
                             format="csr")).tocsr().astype(dtype)
    hyb = (band + _hermitian_sparse(n, 0.002, 7, dtype)
           - sp.diags(np.arange(n, dtype=float))).tocsr().astype(dtype)
    jb = JO.BandedOperator.from_scipy(band.todia())
    jh = JO.dia_ell_hybrid(hyb)
    assert isinstance(jh, JO.SumOperator)
    out = [("banded", jb, CV.banded_from_jax(jb), band)]
    for name, A in (("ell", scat), ("ell rect", rect)):
        je = JO.ELLOperator.from_scipy(A)
        out.append((name, je, CV.ell_from_jax(je), A))
    for name, A, tr in (("blockell", scat, False), ("blockell rect", rect,
                                                    True)):
        jbe = JO.BlockELLOperator.from_scipy(A, block_size=4,
                                             with_transpose=tr)
        out.append((name, jbe, CV.block_ell_from_jax(jbe), A))
    out.append(("hybrid", jh, CV.sum_from_jax(jh), hyb))
    jd = JO.DenseOperator(jnp.asarray(scat.toarray()))
    out.append(("dense", jd, CV.dense_from_jax(jd), scat))
    return out


@pytest.mark.parametrize("dtype", CTYPES)
def test_complex_operators_match_reference(dtype):
    rng = np.random.default_rng(0)
    rel = REL[np.dtype(dtype)]
    for name, jop, top, A in _ops(dtype):
        assert top.dtype == getattr(torch, np.dtype(dtype).name), name
        m, n = A.shape
        X, Y = _crand(rng, (n, 3), dtype), _crand(rng, (m, 3), dtype)
        ref = A.astype(np.complex128) @ X.astype(np.complex128)
        _close(top.matmat(torch.as_tensor(X)).numpy(),
               np.asarray(jop.matmat(jnp.asarray(X))), rel)
        _close(top.matmat(torch.as_tensor(X)).numpy(), ref, rel)
        if name != "blockell" and m == n or name.endswith("rect"):
            refh = A.conj().T.astype(np.complex128) @ Y.astype(np.complex128)
            _close(top.rmatmat(torch.as_tensor(Y)).numpy(),
                   np.asarray(jop.rmatmat(jnp.asarray(Y))), rel)
            _close(top.rmatmat(torch.as_tensor(Y)).numpy(), refh, rel)
        if m == n and jop.diagonal() is not None:
            _close(top.diagonal().numpy(), np.asarray(jop.diagonal()), rel)


@pytest.mark.parametrize("dtype", CTYPES)
def test_complex_ell_layout_conjugates_the_adjoint(dtype):
    # A^H's layout holds the conjugated values (the kernel never
    # conjugates); the reference's valsT holds them unconjugated
    A = _hermitian_sparse(200, 0.03, 2, dtype)
    A = (A + sp.random(200, 200, density=0.01, random_state=9) * 1j).tocsr() \
        .astype(dtype)
    top = ptt.ELLOperator.from_scipy(A)
    lay = WE.from_csr(A.conj().T.tocsr(), np.dtype(dtype))
    assert np.array_equal(top.vals_t.numpy(), lay.vals)
    je = JO.ELLOperator.from_scipy(A)
    lay_ref = WE.from_csr(A.T.tocsr(), np.dtype(dtype))
    assert np.array_equal(top.vals_t.numpy(), lay_ref.vals.conj())
    assert np.abs(np.asarray(je.valsT)).sum() > 0


@pytest.mark.parametrize("dtype", CTYPES)
def test_dia_plain_versions_against_scipy(dtype):
    rng = np.random.default_rng(1)
    A = _banded_complex(257, dtype)
    top = ptt.BandedOperator.from_scipy(A)
    for k in (1, 2, 5):
        X = _crand(rng, (257, k), dtype)
        Xt = torch.as_tensor(X)
        A64 = A.astype(np.complex128)
        y = DK.matmat_reference(top.vals, top.offsets, Xt)
        yh = DK.rmatmat_reference(top.vals, top.offsets, Xt)
        assert y.dtype == yh.dtype == Xt.dtype
        _close(y.numpy(), A64 @ X, REL[np.dtype(dtype)])
        _close(yh.numpy(), A64.conj().T @ X, REL[np.dtype(dtype)])
        # the wrapper on CPU tensors is the plain version, no launch
        before = dict(DK.KERNEL_LAUNCHES)
        assert torch.equal(DK.matmat(top.vals, top.offs, Xt, adjoint=True),
                           yh)
        assert DK.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype", CTYPES)
def test_dia_plain_complex_product_rounds_part_by_part(dtype):
    # one term: (vr xr - vi xi, vr xi + vi xr), each operation rounded
    # once in the real type, the order the kernel keeps
    rng = np.random.default_rng(2)
    rdt = np.float32 if dtype == np.complex64 else np.float64
    v, x = _crand(rng, (1, 64), dtype), _crand(rng, (64, 1), dtype)
    y = DK.matmat_reference(torch.as_tensor(v), (0,),
                            torch.as_tensor(x)).numpy()[:, 0]
    vr, vi = v[0].real.astype(rdt), v[0].imag.astype(rdt)
    xr, xi = x[:, 0].real.astype(rdt), x[:, 0].imag.astype(rdt)
    z = rdt(0)
    assert np.array_equal(y.real, z + (vr * xr - vi * xi))
    assert np.array_equal(y.imag, z + (vr * xi + vi * xr))


@pytest.mark.parametrize("dtype", CTYPES)
@pytest.mark.parametrize("shape", [(500, 500), (700, 230), (230, 700)])
def test_sliced_ell_plain_version_against_scipy(dtype, shape):
    rng = np.random.default_rng(3)
    m, n = shape
    A = (sp.random(m, n, density=0.02, random_state=1, format="lil")
         + 1j * sp.random(m, n, density=0.02, random_state=2, format="lil"))
    A = A.tolil()
    A[40:90] = 0                        # empty rows and slices
    A = A.tocsr().astype(dtype)
    lay = WE.from_csr(A, np.dtype(dtype))
    assert lay.vals.dtype == np.dtype(dtype)
    arrays = [torch.as_tensor(getattr(lay, f)) for f in WE.SlicedELL._fields]
    for k in (1, 3, 8):
        X = _crand(rng, (n, k), dtype)
        y = WE.matmat_reference(*arrays, torch.as_tensor(X), n)
        _close(y.numpy(), A.astype(np.complex128) @ X, REL[np.dtype(dtype)])
        before = dict(WE.KERNEL_LAUNCHES)
        assert torch.equal(WE.matmat(*arrays, torch.as_tensor(X), n), y)
        assert WE.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_real_operator_on_complex_block_multiplies_both_parts(dtype):
    # the repair: each real operator's product of a complex block is the
    # product of its real and its imaginary part, as the reference's
    # products promote (before it, the cast to the operator's type
    # dropped the imaginary part)
    rng = np.random.default_rng(4)
    rel = REL[np.dtype(dtype)]
    n = 343
    T = _banded_complex(n, np.complex128).real.tocsr()
    T = (T + T.T).tocsr().astype(dtype)
    S = (sp.random(n, n, density=0.02, random_state=3)).tocsr().astype(dtype)
    S2 = (sp.random(n, n, density=0.002, random_state=6)).tocsr() \
        .astype(dtype)
    tdt = getattr(torch, np.dtype(dtype).name)
    ops = {"banded": (ptt.BandedOperator.from_scipy(T),
                      JO.BandedOperator.from_scipy(T.todia()), T),
           "ell": (ptt.ELLOperator.from_scipy(S),
                   JO.ELLOperator.from_scipy(S), S),
           "blockell": (ptt.BlockELLOperator.from_scipy(S, 4, True),
                        JO.BlockELLOperator.from_scipy(S, 4, True), S),
           "dense": (ptt.DenseOperator(T.toarray()),
                     JO.DenseOperator(jnp.asarray(T.toarray())), T),
           "hybrid": (ptt.operators.dia_ell_hybrid(T + 0.1 * S2), None,
                      (T + 0.1 * S2).tocsr()),
           "function": (ptt.aslinearoperator(spla.aslinearoperator(S)),
                        None, S),
           # the reference's stencil casts the block to its real type,
           # dropping the imaginary part (ROADMAP Queue C): no parity there
           "stencil": (ptt.Stencil3DOperator(7, 7, 7, dtype=tdt,
                                             device="cpu"), None, None),
           "jacobi": (ptt.JacobiPrecond(np.arange(1.0, n + 1).astype(dtype)),
                      JO.JacobiPrecond(jnp.arange(1.0, n + 1, dtype=dtype)),
                      sp.diags(1.0 / np.arange(1.0, n + 1)))}
    X = _crand(rng, (n, 3))
    for name, (top, jop, A) in ops.items():
        Y = top.matmat(torch.as_tensor(X))
        assert Y.is_complex(), name
        parts = (top.matmat(torch.as_tensor(X.real)).numpy()
                 + 1j * top.matmat(torch.as_tensor(X.imag)).numpy())
        _close(Y.numpy(), parts, rel)
        if A is not None:
            _close(Y.numpy(), A.astype(np.float64) @ X, 10 * rel)
        if jop is not None:
            _close(Y.numpy(), np.asarray(jop.matmat(jnp.asarray(X))),
                   10 * rel)
        if name in ("banded", "ell", "blockell"):
            _close(top.rmatmat(torch.as_tensor(X)).numpy(),
                   A.T.astype(np.float64) @ X, 10 * rel)
    # the shifted Jacobi apply divides both parts of column j by d - s_j
    J = ops["jacobi"][0]
    sh = torch.tensor([0.5, 3.5, -2.0], dtype=tdt)
    d = np.arange(1.0, n + 1)
    _close(J.matmat_shifted(torch.as_tensor(X), sh).numpy(),
           X / (d[:, None] - sh.numpy()[None, :]), 10 * rel)


def test_complex_rand_block_draws_real_then_imaginary():
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    Z = tl.rand_block(g1, 50, 3, torch.complex128, "cpu")
    re = torch.randn((50, 3), generator=g2, dtype=torch.float64)
    im = torch.randn((50, 3), generator=g2, dtype=torch.float64)
    assert torch.equal(Z, torch.complex(re, im))
    g3, g4 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    Z64 = tl.rand_block(g3, 50, 3, torch.complex64, "cpu")
    re32 = torch.randn((50, 3), generator=g4, dtype=torch.float32)
    assert torch.equal(Z64, torch.complex(
        re32, torch.randn((50, 3), generator=g4, dtype=torch.float32)))


def _both(x):
    x = np.asarray(x, np.complex128)
    return jnp.asarray(x), torch.as_tensor(x)


def test_complex_gram_block_ortho_eigh_residuals():
    # the cases of tests/test_linalg.py with complex128
    rng = np.random.default_rng(5)
    tol = 1e-12
    n, m, b, bs = 300, 12, 7, 3
    X, Y = _crand(rng, (n, 6)), _crand(rng, (n, 4))
    (Xj, Xt), (Yj, Yt) = _both(X), _both(Y)
    _close(tl.gram(Xt, Yt).numpy(), np.asarray(jl.gram(Xj, Yj)), tol)
    V = np.zeros((n, m), np.complex128)
    V[:, :b] = np.linalg.qr(_crand(rng, (n, b)))[0]
    Z = _crand(rng, (n, bs))
    (Vj, Vt), (Zj, Zt) = _both(V), _both(Z)
    rj = jl.block_ortho(Zj, (Vj, Vj), None, jnp.int32(bs),
                        jax.random.PRNGKey(0))
    rt = tl.block_ortho(Zt, Vt, None, bs, torch.Generator().manual_seed(0))
    assert int(rj.n_random) == rt.n_random == 0
    _close(rt.X.numpy(), np.asarray(rj.X), 10 * tol)
    Q = rt.X.numpy()
    _close(Q.conj().T @ Q, np.eye(bs), 10 * tol)
    _close(V.conj().T @ Q, np.zeros((m, bs)), 10 * tol)
    # a dependent column is replaced by a complex random one, orthonormal
    Z2 = Z.copy()
    Z2[:, 2] = V[:, :b] @ _crand(rng, (b,))       # inside span(V)
    rt2 = tl.block_ortho(torch.as_tensor(Z2), Vt, None, bs,
                         torch.Generator().manual_seed(0))
    assert rt2.n_random == 1
    Q2 = rt2.X.numpy()
    assert np.abs(Q2[:, 2].imag).max() > 0
    _close(Q2.conj().T @ Q2, np.eye(bs), 10 * tol)
    # the projected eigenproblem of a complex Hermitian block
    H = _crand(rng, (8, 8))
    H = H + H.conj().T
    w, U = tl.projected_eigh(torch.as_tensor(H))
    wj, Uj = np.linalg.eigh(H)
    _close(w.numpy(), wj, tol)
    assert w.dtype == torch.float64 and U.dtype == torch.complex128
    _close(U.numpy() @ np.diag(w.numpy()) @ U.numpy().conj().T, H, tol)
    w64, _ = tl.projected_eigh(torch.as_tensor(H.astype(np.complex64)))
    assert w64.dtype == torch.float32
    # compute_residuals: candidates from a complex coefficient block
    W = _crand(rng, (n, m))
    W[:, 9:] = 0
    hv = _crand(rng, (m, 4))
    hv[:, 3] = 0
    hl = np.array([0.5, 1.0, 2.0, np.finfo(np.float64).max])
    cj = jl.compute_residuals(Vj, jnp.asarray(W), None, jnp.asarray(hv),
                              jnp.asarray(hl))
    ct = tl.compute_residuals(Vt, torch.as_tensor(W), None,
                              torch.as_tensor(hv), torch.as_tensor(hl))
    for f in ("X", "WX", "R", "resnorms", "xnorms"):
        _close(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), tol)
    assert ct.resnorms.dtype == torch.float64


def _inner_state(n, lockmax, anorm, jax_side):
    if jax_side:
        z = jnp.zeros((n, lockmax), jnp.complex128)
        stats = types.SimpleNamespace(
            num_outer_iterations=jnp.int32(3),
            anorm_estimate=jnp.asarray(anorm, jnp.float64),
            num_matvecs=jnp.int32(50))
        return types.SimpleNamespace(num_locked=jnp.int32(0), evecs=z,
                                     Bevecs=z, stats=stats)
    stats = types.SimpleNamespace(num_outer_iterations=3,
                                  anorm_estimate=anorm, num_matvecs=50)
    return types.SimpleNamespace(
        num_locked=0, evecs=torch.zeros((n, lockmax), dtype=torch.complex128),
        stats=stats)


@pytest.mark.parametrize("method", ["JDQMR_ETol", "JDQMR"])
def test_complex_jdqmr_inner_solve_matches_reference(method):
    rng = np.random.default_rng(6)
    n, blk, m = 300, 2, 10
    Q = np.linalg.qr(_crand(rng, (n, n)))[0]
    A = (Q * np.linspace(0.1, 40.0, n)) @ Q.conj().T
    A = 0.5 * (A + A.conj().T)
    V = np.linalg.qr(_crand(rng, (n, m)))[0]
    w, Z = np.linalg.eigh(V.conj().T @ A @ V)
    X = V @ Z[:, :blk]
    lam = w[:blk]
    R = A @ X - X * lam
    res = np.linalg.norm(R, axis=0)
    vmask = np.array([True, True])
    p = jp.set_method(jp.Method[method],
                      jp.PrimmeParams(n=n, num_evals=4, max_block_size=blk,
                                      eps=1e-8))
    cfg_j, cfg_t = js.make_config(p), ts.make_config(params_from_jax(p))
    anorm = 40.0
    c = lambda a: jnp.asarray(a)    # noqa: E731
    out_j = ji.jdqmr_inner_solve(
        cfg_j, JO.DenseOperator(c(A)), None, None,
        _inner_state(n, cfg_j.lockmax, anorm, True), c(X), c(X), c(R),
        c(lam), c(res), c(vmask), c(1e-8 * anorm), evals=c(lam))
    t = torch.as_tensor
    out_t = ti.jdqmr_inner_solve(
        cfg_t, ptt.DenseOperator(A), None, None,
        _inner_state(n, cfg_t.lockmax, anorm, False), t(X), t(X), t(R),
        t(lam), t(res), t(vmask), 1e-8 * anorm, evals=t(lam))
    sol_j, its_j, nmv_j, nprec_j = (np.asarray(x) for x in out_j)
    sol_t, its_t, nmv_t, nprec_t, trace_t = out_t
    assert trace_t is None      # no inner_trace_cap, no step buffer
    assert (int(its_j), int(nmv_j), int(nprec_j)) == (its_t, nmv_t, nprec_t)
    assert its_t > 1 and sol_t.dtype == torch.complex128
    assert np.abs(sol_t.numpy().imag).max() > 0
    _close(sol_t.numpy(), sol_j, 1e-9)


def _hermitian_fixture():
    # tests/test_eigsh.py::test_complex_hermitian
    rng = np.random.default_rng(3)
    n = 150
    H = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return (H + H.conj().T) / 2 + np.diag(np.linspace(0, 50, n))


def test_complex_hermitian_eigsh_matches_reference():
    H = _hermitian_fixture()
    ref = np.linalg.eigvalsh(H)
    kw = dict(k=5, which="SA", tol=1e-9, raise_for_unconverged=False,
              return_stats=True)
    wj, Vj, sj = primme_tpu.eigsh(H, **kw)
    for A in (H, torch.as_tensor(H), sp.csr_matrix(H),
              spla.aslinearoperator(H)):
        wt, Vt, st = ptt.eigsh(A, device="cpu", **kw)
        assert Vt.dtype == np.complex128 and wt.dtype == np.float64
        # the fixture's bar (tests/test_eigsh.py's assert_close)
        assert np.abs(np.sort(wt) - ref[:5]).max() <= 1e-6 * max(
            1.0, np.abs(ref[:5]).max())
        R = H @ Vt - Vt * wt[None, :]
        assert np.linalg.norm(R, axis=0).max() <= 10 * 1e-9 * np.abs(ref).max()
        assert st["num_matvecs"] <= 2 * sj["num_matvecs"]
    assert np.abs(np.sort(wj) - ref[:5]).max() <= 1e-6 * np.abs(ref).max()


def test_complex_working_types():
    H = _hermitian_fixture()
    ref = np.linalg.eigvalsh(H)
    # complex128 input solved in complex64, as in the reference
    kw = dict(k=4, which="SA", tol=1e-5, return_stats=True)
    wt, Vt, st = ptt.eigsh(H, dtype=np.complex64, device="cpu", **kw)
    wj, Vj, sj = primme_tpu.eigsh(H, dtype=np.complex64, **kw)
    assert Vt.dtype == np.complex64
    for w in (wt, wj):
        assert np.abs(np.sort(w) - ref[:4]).max() <= 1e-4 * np.abs(ref).max()
    assert st["num_matvecs"] <= 2 * sj["num_matvecs"]
    # a complex working type over a real operator is refused by name (the
    # reference's cast drops the block's imaginary part and its solve does
    # not converge); so is a real one over a complex operator
    with pytest.raises(NotImplementedError, match="working dtype"):
        ptt.eigsh(H.real.copy(), k=2, dtype=np.complex64, device="cpu")
    with pytest.raises(NotImplementedError, match="working dtype"):
        ptt.eigsh(H, k=2, dtype=np.float64, device="cpu")
    # since the twelfth slice a complex JacobiPrecond is served: the
    # complex diagonal's solve runs as the reference's (the same values,
    # matvecs and preconditioner applies)
    kj = dict(k=2, which="SA", tol=1e-8, return_stats=True)
    wt, _, st = ptt.eigsh(sp.csr_matrix(H), jacobi=True, device="cpu", **kj)
    wj, _, sj = primme_tpu.eigsh(sp.csr_matrix(H), jacobi=True, **kj)
    assert np.abs(np.sort(wt) - ref[:2]).max() <= 1e-7 * np.abs(ref).max()
    assert np.abs(np.sort(wt) - np.sort(wj)).max() <= 1e-7 * np.abs(ref).max()
    assert st["num_preconds"] > 0
    assert st["num_matvecs"] <= 2 * sj["num_matvecs"]
    # the bf16 basis over a complex operator: the reference casts the
    # block to the real half type and drops its imaginary part (its values
    # miss the spectrum); the port refuses the real/complex mix by name
    with pytest.raises(NotImplementedError, match="working dtype"):
        ptt.eigsh(H, k=2, dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("dtype,wide", [(torch.float32, torch.float64),
                                        (torch.complex64, torch.complex128)])
def test_single_precision_gram_sums_in_double(dtype, wide):
    # a Gram of single-precision blocks is the double-precision one
    # rounded once (the card's f32 sums over n rows lost the basis'
    # orthonormality); double-precision blocks are summed as they are
    g = torch.Generator().manual_seed(3)
    X = torch.randn((5000, 6), generator=g, dtype=dtype)
    Y = torch.randn((5000, 4), generator=g, dtype=dtype)
    G = tl.gram(X, Y)
    assert G.dtype == dtype
    assert torch.equal(G, (X.to(wide).mH @ Y.to(wide)).to(dtype))
    assert torch.equal(tl.gram(X.to(wide), Y.to(wide)),
                       X.to(wide).mH @ Y.to(wide))
