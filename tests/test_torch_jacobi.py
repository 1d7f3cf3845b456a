"""The port's shift-aware Jacobi preconditioner (primme_tpu_torch
JacobiPrecond and ops/jacobi.py) against the JAX package's JacobiPrecond on
the same numpy inputs, and ``apply_precond``'s routing of the shifts.

Tolerance: none. Each element is one IEEE division (shifted) or an IEEE
reciprocal and one product (unshifted) on both sides, in the form the
reference writes, so the results agree bit for bit, NaN for NaN."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from primme_tpu import operators as JO
import primme_tpu_torch as ptt
from primme_tpu_torch.convert import jacobi_from_jax
from primme_tpu_torch.ops import jacobi as JK

DTYPES = [np.float32, np.float64]


def _tdt(dtype):
    return getattr(torch, np.dtype(dtype).name)


def _inputs(dtype, n=60, k=4, seed=3):
    """A diagonal with negative entries and a zero, a block with a NaN and
    an Inf, and shifts: one equal to a diagonal entry (its denominator is
    0, under eps: the clamp), one inside the diagonal's range."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-3.0, 5.0, n).astype(dtype)
    d[11] = 0.0
    X = rng.normal(size=(n, k)).astype(dtype)
    X[5, 0], X[9, 2] = np.nan, np.inf
    s = np.array([d[7], 0.25, -1.5, 2.0][:k], dtype)
    return d, X, s


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a, b, equal_nan=True)


@pytest.mark.parametrize("eps", [1e-10, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_matches_reference(dtype, eps):
    d, X, s = _inputs(dtype)
    jk = JO.JacobiPrecond(jnp.asarray(d), eps=eps)
    tk = ptt.JacobiPrecond(d, eps=eps)
    assert tk.dtype == _tdt(dtype) and tk.shape == jk.shape
    Xt, st = torch.as_tensor(X), torch.as_tensor(s)
    yj = np.asarray(jk.matmat_shifted(jnp.asarray(X), jnp.asarray(s)))
    y = tk.matmat_shifted(Xt, st).numpy()
    assert _same(y, yj)
    # the clamp fired: d[7] - s[0] = 0 -> eps
    assert y[7, 0] == (X[7, 0] / dtype(eps))
    assert _same(tk.matmat(Xt).numpy(), np.asarray(jk.matmat(jnp.asarray(X))))
    # a NaN in X stays in its element and nowhere else
    assert np.isnan(y[5, 0]) and np.isnan(y).sum() == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_nan_denominator_propagates(dtype):
    d, X, s = _inputs(dtype)
    d[20] = np.nan
    s[1] = np.nan
    jk = JO.JacobiPrecond(jnp.asarray(d))
    tk = ptt.JacobiPrecond(d)
    y = tk.matmat_shifted(torch.as_tensor(X), torch.as_tensor(s)).numpy()
    assert _same(y, np.asarray(jk.matmat_shifted(jnp.asarray(X),
                                                 jnp.asarray(s))))
    assert np.isnan(y[20]).all() and np.isnan(y[:, 1]).all()
    y = tk.matmat(torch.as_tensor(X)).numpy()
    assert _same(y, np.asarray(jk.matmat(jnp.asarray(X))))
    assert np.isnan(y[20]).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_without_shifts(dtype):
    d, X, s = _inputs(dtype)
    jk = JO.JacobiPrecond(jnp.asarray(d), use_shifts=False)
    tk = ptt.JacobiPrecond(d, use_shifts=False)
    y = tk.matmat_shifted(torch.as_tensor(X), torch.as_tensor(s)).numpy()
    assert _same(y, np.asarray(jk.matmat_shifted(jnp.asarray(X),
                                                 jnp.asarray(s))))
    assert _same(y, tk.matmat(torch.as_tensor(X)).numpy())


def test_jacobi_two_forms_round_differently():
    # one division against a reciprocal and a product: some elements
    # differ by an ulp, so neither form may stand in for the other
    rng = np.random.default_rng(0)
    d = rng.uniform(1.0, 9.0, 4000).astype(np.float32)
    X = rng.normal(size=(4000, 1)).astype(np.float32)
    tk = ptt.JacobiPrecond(d)
    a = tk.matmat(torch.as_tensor(X))
    b = tk.matmat_shifted(torch.as_tensor(X), torch.zeros(1))
    assert not torch.equal(a, b)
    assert torch.allclose(a, b, rtol=2 ** -22, atol=0)


def test_jacobi_column_slice():
    d, X, s = _inputs(np.float32, k=4)
    tk = ptt.JacobiPrecond(d)
    W = torch.as_tensor(X)
    y = tk.matmat_shifted(W[:, 1:3], torch.as_tensor(s[1:3]))
    assert _same(y.numpy(), tk.matmat_shifted(
        W[:, 1:3].contiguous(), torch.as_tensor(s[1:3])).numpy())


def test_jacobi_keeps_a_contiguous_diagonal():
    # a DenseOperator's diagonal is a strided view; the kernel takes d
    # contiguous, so JacobiPrecond keeps a contiguous copy
    A = np.random.default_rng(3).normal(size=(6, 6))
    d = ptt.DenseOperator(A).diagonal()
    assert not d.is_contiguous()
    tk = ptt.JacobiPrecond(d)
    assert tk.d.is_contiguous() and torch.equal(tk.d, d)


def test_jacobi_cpu_makes_no_launch():
    d, X, s = _inputs(np.float64)
    tk = ptt.JacobiPrecond(d)
    before, by_entry = JK.LAUNCHES, dict(JK.KERNEL_LAUNCHES)
    tk.matmat(torch.as_tensor(X))
    tk.matmat_shifted(torch.as_tensor(X), torch.as_tensor(s))
    assert JK.LAUNCHES == before and JK.KERNEL_LAUNCHES == by_entry


class _Shifted(ptt.LinearOperator):
    """Records what ``apply_precond`` calls."""

    def __init__(self):
        super().__init__()
        self.register_buffer("d", torch.ones(3))
        self.shape, self.dtype, self.calls = (3, 3), torch.float32, []

    def matmat(self, X):
        self.calls.append("matmat")
        return X

    def matmat_shifted(self, X, shifts):
        self.calls.append(("matmat_shifted", shifts.tolist()))
        return X


def test_apply_precond_routes_the_shifts():
    K = _Shifted()
    X = torch.ones((3, 2))
    ptt.apply_precond(K, X, torch.tensor([0.5, 2.0]))
    ptt.apply_precond(K, X)
    assert K.calls == [("matmat_shifted", [0.5, 2.0]), "matmat"]
    # a preconditioner with no shifted form gets matmat
    D = ptt.DiagonalOperator(np.array([2.0, 4.0, 8.0], np.float32))
    y = ptt.apply_precond(D, X, torch.tensor([0.5, 2.0]))
    assert torch.equal(y, D.matmat(X))
    # the shifted Jacobi apply, through apply_precond, against the reference
    d, Xn, s = _inputs(np.float32)
    y = ptt.apply_precond(ptt.JacobiPrecond(d), torch.as_tensor(Xn),
                          torch.as_tensor(s)).numpy()
    yj = JO.apply_precond(JO.JacobiPrecond(jnp.asarray(d)), jnp.asarray(Xn),
                          jnp.asarray(s))
    assert _same(y, np.asarray(yj))


def test_apply_precond_without_preconditioner_is_identity():
    X = torch.randn(5, 2)
    assert ptt.apply_precond(None, X, torch.tensor([1.0, 2.0])) is X
    assert ptt.apply_precond(None, X) is X


@pytest.mark.parametrize("op_dtype,work_dtype", [
    (np.float64, np.float32), (np.float32, np.float64)])
def test_cast_operator_over_jacobi(op_dtype, work_dtype):
    d, X, s = _inputs(op_dtype)
    X, s = X.astype(work_dtype), s.astype(work_dtype)
    tw = _tdt(work_dtype)
    jc = JO.CastOperator(JO.JacobiPrecond(jnp.asarray(d)), work_dtype)
    tc = ptt.CastOperator(ptt.JacobiPrecond(d), tw)
    assert tc.diagonal() is None and jc.diagonal() is None
    y = tc.matmat_shifted(torch.as_tensor(X), torch.as_tensor(s)).numpy()
    assert _same(y, np.asarray(jc.matmat_shifted(jnp.asarray(X),
                                                 jnp.asarray(s))))
    y = ptt.apply_precond(tc, torch.as_tensor(X), torch.as_tensor(s)).numpy()
    assert _same(y, np.asarray(JO.apply_precond(jc, jnp.asarray(X),
                                                jnp.asarray(s))))
    assert _same(tc.matmat(torch.as_tensor(X)).numpy(),
                 np.asarray(jc.matmat(jnp.asarray(X))))


@pytest.mark.parametrize("use_shifts", [True, False])
def test_jacobi_from_jax(use_shifts):
    d, X, s = _inputs(np.float32)
    jk = JO.JacobiPrecond(jnp.asarray(d), eps=1e-3, use_shifts=use_shifts)
    tk = jacobi_from_jax(jk, "cpu")
    assert tk.eps == 1e-3 and tk.use_shifts == use_shifts
    assert tk.device == torch.device("cpu")
    assert np.array_equal(tk.d.numpy(), d)
    y = tk.matmat_shifted(torch.as_tensor(X), torch.as_tensor(s)).numpy()
    assert _same(y, np.asarray(jk.matmat_shifted(jnp.asarray(X),
                                                 jnp.asarray(s))))


def test_jacobi_wrappers_refuse_other_devices():
    # a CPU tensor runs the plain version, a CUDA one the kernel; nothing
    # else is taken (the meta device stands in for one)
    X, d = torch.empty((4, 2), device="meta"), torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        JK.shifted(X, d, torch.empty(2, device="meta"), 1e-10)
    with pytest.raises(ValueError, match="unsupported device"):
        JK.unshifted(X, d, 1e-10)
