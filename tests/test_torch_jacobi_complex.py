"""The complex Jacobi preconditioner of the port (a complex diagonal, or a
real one given complex shifts) against the JAX package's JacobiPrecond on
the same numpy inputs, on the CPU: the plain complex applies, the repair of
complex shifts on a real diagonal (the port divided by the real part of
``d - sigma``), ``eigs`` with a real JacobiPrecond from a shared start,
complex Hermitian ``eigsh(jacobi=True)`` and the config-file harness with
the Jacobi PrecChoice on a complex matrix.

Tolerances: the plain versions divide on the real and imaginary parts as
torch's complex type does (Smith's branches, one rounding an operation),
XLA by its own complex division, so the applies agree to a few units of
the type's eps relative to the element (``REL`` eps); where ``d - sigma``
is real in value (a Hermitian diagonal and real shifts) both are a
reciprocal and a product, or one real division of each part, and agree to
the same bound. Solves: values within their solver's tolerance of the
dense spectrum, matvecs within 2x of the JAX package's."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import primme_tpu
from primme_tpu import operators as JO
import primme_tpu_torch as ptt
from primme_tpu_torch.ops import jacobi as JK
import chip_smoke as CS

REL = 8          # eps of the type, relative to the element's modulus
MV_SLACK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # beside parallel test workers, extra intra-op threads only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dtype, real_den, n=64, k=4, seed=5):
    """A complex diagonal (real in value with ``real_den``) with one zero,
    a complex block and shifts, the first equal to a diagonal entry (its
    denominator is 0: the eps guard fires)."""
    rng = np.random.default_rng(seed)
    rdt = np.finfo(dtype).dtype
    d = rng.uniform(-3, 5, n).astype(rdt) + 0j
    s = rng.uniform(-1, 2, k) + 0j
    if not real_den:
        d = d + 1j * rng.normal(size=n)
        s = s + 1j * rng.normal(size=k)
    d[11] = 0
    s[0] = d[7]
    X = rng.normal(size=(n, k)) + 1j * rng.normal(size=(n, k))
    return d.astype(dtype), X.astype(dtype), s.astype(dtype)


def _close(y, yj, dtype):
    eps = np.finfo(dtype).eps
    err = np.abs(y - yj) / np.maximum(np.abs(yj), np.finfo(dtype).tiny)
    return float(err.max()) <= REL * eps


@pytest.mark.parametrize("real_den", [True, False])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_jacobi_matches_reference(dtype, real_den):
    d, X, s = _inputs(dtype, real_den)
    eps = 1e-10
    jk = JO.JacobiPrecond(jnp.asarray(d), eps=eps)
    tk = ptt.JacobiPrecond(d, eps=eps)
    assert tk.dtype == getattr(torch, np.dtype(dtype).name)
    yj = np.asarray(jk.matmat_shifted(jnp.asarray(X), jnp.asarray(s)))
    y = tk.matmat_shifted(torch.as_tensor(X), torch.as_tensor(s)).numpy()
    assert y.dtype == dtype and _close(y, yj, dtype)
    # the guard fired: d[7] - s[0] = 0 -> eps + 0i
    e = np.finfo(dtype).dtype.type(eps)
    assert _close(y[7, :1], X[7, :1] / e, dtype)
    yj = np.asarray(jk.matmat(jnp.asarray(X)))
    y = tk.matmat(torch.as_tensor(X)).numpy()
    assert _close(y, yj, dtype)
    # the zero diagonal entry is guarded too: 1 / eps
    assert np.isfinite(y).all()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_plain_versions_against_numpy(dtype):
    """The kernel's plain versions (the parts, c10's division) against
    numpy's complex division and reciprocal, and NaN staying in its
    element."""
    d, X, s = _inputs(dtype, False)
    X[3, 1] = np.nan
    eps = 1e-10
    Xt, dt_, st = (torch.as_tensor(a) for a in (X, d, s))
    den = d[:, None] - s[None, :]
    den = np.where(np.abs(den) < eps, eps, den)
    y = JK.shifted_reference(Xt, dt_, st, eps).numpy()
    ok = ~np.isnan(X)
    assert np.isnan(y[3, 1]) and np.isnan(y).sum() == 1
    assert _close(y[ok], (X / den)[ok], dtype)
    dd = np.where(np.abs(d) < eps, eps, d)
    y = JK.unshifted_reference(Xt, dt_, eps).numpy()
    assert _close(y[ok], ((1 / dd)[:, None] * X)[ok], dtype)
    # the wrappers run the plain versions on CPU tensors, bit for bit
    for a, b in ((JK.shifted(Xt, dt_, st, eps),
                  JK.shifted_reference(Xt, dt_, st, eps)),
                 (JK.unshifted(Xt, dt_, eps),
                  JK.unshifted_reference(Xt, dt_, eps))):
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)


def test_complex_divide_follows_smiths_branches():
    # |re| >= |im| and |re| < |im| branches, a zero denominator
    a = torch.tensor([1.0, 2.0, 3.0, 1.0], dtype=torch.float64)
    b = torch.tensor([0.5, -1.0, 0.0, 1.0], dtype=torch.float64)
    c = torch.tensor([2.0, 0.1, 0.0, 0.0], dtype=torch.float64)
    d = torch.tensor([0.5, 3.0, 0.0, 2.0], dtype=torch.float64)
    re, im = JK.complex_divide(a, b, c, d)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (a.numpy() + 1j * b.numpy()) / (c.numpy() + 1j * d.numpy())
    for i in (0, 1, 3):
        assert abs(complex(re[i], im[i]) - z[i]) <= 4e-16 * abs(z[i])
    assert not np.isfinite(re[2].item())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_real_diagonal_with_complex_shifts_matches_reference(dtype):
    """The repair: a real diagonal given complex shifts divides by the
    complex ``d - sigma_j``, as the reference promotes them. Before it,
    the port cast the shifts to the diagonal's real type (24.5 off on
    outputs of size 3.0 for these inputs)."""
    rng = np.random.default_rng(0)
    d = rng.uniform(1, 3, 8).astype(dtype)
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    X = (rng.normal(size=(8, 2)) + 1j * rng.normal(size=(8, 2))).astype(cdt)
    sh = np.array([1.5 + 0.7j, 2.0 - 0.4j], cdt)
    yj = np.asarray(JO.JacobiPrecond(jnp.asarray(d)).matmat_shifted(
        jnp.asarray(X), jnp.asarray(sh)))
    y = ptt.JacobiPrecond(d).matmat_shifted(torch.as_tensor(X),
                                            torch.as_tensor(sh)).numpy()
    assert y.dtype == cdt and _close(y, yj, cdt)
    # real shifts keep the real route: both parts by the real d - sigma
    shr = sh.real.astype(dtype)
    yj = np.asarray(JO.JacobiPrecond(jnp.asarray(d)).matmat_shifted(
        jnp.asarray(X), jnp.asarray(shr)))
    y = ptt.JacobiPrecond(d).matmat_shifted(torch.as_tensor(X),
                                            torch.as_tensor(shr)).numpy()
    assert np.array_equal(y, yj)


def _normal_matrix():
    # tests/test_normal.py's fixture
    rng = np.random.default_rng(0)
    n = 120
    Q = np.linalg.qr(rng.normal(size=(n, n))
                     + 1j * rng.normal(size=(n, n)))[0]
    d = rng.normal(size=n) + 1j * rng.normal(size=n)
    return (Q * d[None, :]) @ Q.conj().T, d


def _start(n):
    """The JAX package's seed-0 start block (``tests/test_torch_normal.py``'s
    shared start)."""
    from primme_tpu.core.solver import _rand_block

    key = jax.random.split(jax.random.PRNGKey(0))[1]
    return np.array(_rand_block(key, n, 1, jnp.complex128))


def test_eigs_with_real_jacobi_matches_reference():
    """``eigs`` with OPinv a real JacobiPrecond (the real part of the normal
    matrix's diagonal): the preconditioner gets the complex Ritz values as
    shifts. From the JAX package's seed-0 block both packages converge to
    the same four largest-modulus values within the tolerance."""
    A, d = _normal_matrix()
    diag = np.ascontiguousarray(np.diag(A).real)
    v0 = _start(A.shape[0])
    kw = dict(k=4, which="LM", tol=1e-10, method="JDQMR", v0=v0,
              return_stats=True)
    wt, Vt, st = ptt.eigs(A, OPinv=ptt.JacobiPrecond(diag), device="cpu",
                          **kw)
    wj, Vj, sj = primme_tpu.eigs(A, OPinv=JO.JacobiPrecond(jnp.asarray(diag)),
                                 **kw)
    exp = d[np.argsort(-np.abs(d))][:4]
    anorm = np.abs(d).max()
    assert CS.match_values(wt, exp) <= 1e-9 * anorm
    assert CS.match_values(np.asarray(wj), exp) <= 1e-9 * anorm
    R = A @ Vt - Vt * wt[None, :]
    assert np.linalg.norm(R, axis=0).max() <= 10 * 1e-10 * anorm
    assert st["num_preconds"] > 0
    assert st["num_matvecs"] <= MV_SLACK * sj["num_matvecs"]


def _hermitian(n=200, seed=1):
    rng = np.random.default_rng(seed)
    d = np.linspace(1, 50, n)
    off = 0.5 * np.exp(1j * rng.uniform(0, 2 * np.pi, n - 1))
    return sp.diags([d, off, off.conj()], [0, 1, -1]).tocsr()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_hermitian_eigsh_jacobi(dtype):
    H = _hermitian().astype(dtype)
    ref = np.linalg.eigvalsh(H.toarray().astype(np.complex128))
    tol = 1e-5 if dtype == np.complex64 else 1e-10
    kw = dict(k=4, which="SA", tol=tol, jacobi=True, return_stats=True)
    wt, Vt, st = ptt.eigsh(H, device="cpu", **kw)
    wj, _, sj = primme_tpu.eigsh(H, **kw)
    anorm = np.abs(ref).max()
    for w in (wt, np.asarray(wj)):
        assert np.abs(np.sort(w) - ref[:4]).max() <= 10 * tol * anorm
    assert Vt.dtype == dtype and st["num_preconds"] > 0
    assert st["num_matvecs"] <= MV_SLACK * sj["num_matvecs"]


def test_harness_jacobi_on_a_complex_matrix(tmp_path):
    """A config with the Jacobi PrecChoice on a complex Hermitian matrix
    through both packages' ``run_config``: the harness forms
    ``A.diagonal() - shift`` complex, as the reference does."""
    import scipy.io as sio
    from primme_tpu import testharness as JH
    from primme_tpu_torch import testharness as TH

    H = _hermitian(300)
    sio.mmwrite(str(tmp_path / "herm.mtx"), H)
    cfg = tmp_path / "test_herm"
    cfg.write_text("\n".join(["driver.matrixFile    = herm.mtx",
                              "driver.PrecChoice    = jacobi",
                              "primme.numEvals = 4", "primme.eps = 1e-10",
                              "primme.target = primme_smallest"]) + "\n")
    rt = TH.run_config(str(cfg), base_dir=str(tmp_path), device="cpu")
    rj = JH.run_config(str(cfg), base_dir=str(tmp_path))
    assert repr(rt) == "OK" and repr(rj) == "OK"
    ref = np.linalg.eigvalsh(H.toarray())[:4]
    assert np.abs(np.sort(np.asarray(rt.evals)) - ref).max() <= 1e-8 * 50
    assert rt.stats.num_preconds > 0
    assert rt.stats.num_matvecs <= MV_SLACK * int(rj.stats.num_matvecs)
