"""The port's BandedOperator (DIA) against the JAX package's on the same
numpy inputs, on the CPU, where its products run the plain versions of
``ops/dia.py``.

The plain versions are the reference's loop in the same order (``out = out
+ v * shift(X)`` per offset as stored), so they agree with the JAX package
bit for bit here; the tolerance eps(dtype) * B * max|y| is asserted as
well, the bound a reordered sum would meet."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from primme_tpu import operators as JO
import primme_tpu_torch as ptt
from primme_tpu_torch import convert as CV
from primme_tpu_torch.ops import dia as DK

N = 300
# in stored order: sorted, unsorted, offsets past n/2 (and at n - 1), no
# main diagonal
OFFSETS = {"tridiag": (-1, 0, 1), "unsorted": (5, -3, 0, 2, -1),
           "wide": (0, 151, -170, 299, -299), "no_main": (7, -7)}
DTYPES = [np.float32, np.float64]


def _case(offs, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(len(offs), N)).astype(dtype)
    X = rng.normal(size=(N, k)).astype(dtype)
    return vals, X


def _agree(y, yj, nb):
    tol = np.finfo(y.dtype).eps * nb * max(np.abs(yj).max(), 1e-30)
    return (y.dtype == yj.dtype and np.abs(y - yj).max() <= tol
            and np.array_equal(y, yj))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", sorted(OFFSETS))
def test_banded_matches_reference(name, k, dtype):
    offs = OFFSETS[name]
    vals, X = _case(offs, k, dtype)
    jop = JO.BandedOperator(offs, jnp.asarray(vals))
    top = ptt.BandedOperator(offs, vals)
    assert top.offsets == jop.offsets and top.shape == jop.shape
    for fn in ("matmat", "rmatmat"):
        y = getattr(top, fn)(torch.as_tensor(X)).numpy()
        assert _agree(y, np.asarray(getattr(jop, fn)(jnp.asarray(X))),
                      len(offs)), fn
    assert np.array_equal(top.diagonal().numpy(), np.asarray(jop.diagonal()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_banded_is_the_matrix(dtype):
    # matmat is A X and rmatmat A^T X of the matrix the diagonals hold
    offs = OFFSETS["unsorted"]
    vals, X = _case(offs, 2, dtype, seed=1)
    A = np.zeros((N, N))
    for b, off in enumerate(offs):
        i = np.arange(max(0, -off), min(N, N - off))
        A[i, i + off] = vals[b, i]
    top = ptt.BandedOperator(offs, vals)
    tol = 8 * np.finfo(dtype).eps * len(offs) * np.abs(X).max() \
        * np.abs(vals).max()
    Xt = torch.as_tensor(X)
    assert np.abs(top.matmat(Xt).numpy() - A @ X).max() <= tol
    assert np.abs(top.rmatmat(Xt).numpy() - A.T @ X).max() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_from_scipy_keeps_stored_order(dtype):
    # todia() may store offsets in any order; both packages keep scipy's
    rng = np.random.default_rng(2)
    offs = np.array([3, -2, 0, 40, -1])
    D = sp.dia_matrix((rng.normal(size=(5, N)).astype(dtype), offs),
                      shape=(N, N))
    jop, top = JO.BandedOperator.from_scipy(D), ptt.BandedOperator.from_scipy(D)
    assert top.offsets == jop.offsets == tuple(offs)
    assert np.array_equal(top.vals.numpy(), np.asarray(jop.vals))
    assert top.dtype == getattr(torch, np.dtype(dtype).name)
    X = rng.normal(size=(N, 3)).astype(dtype)
    assert np.array_equal(top.matmat(torch.as_tensor(X)).numpy(),
                          np.asarray(jop.matmat(jnp.asarray(X))))
    # the converted reference operator is the same operator
    conv = CV.banded_from_jax(jop)
    assert conv.offsets == top.offsets
    assert torch.equal(conv.vals, top.vals)


def test_from_scipy_when_the_last_columns_are_empty():
    # scipy's DIA data may stop before column n; the padding is zero
    i = np.arange(N - 3)
    A = sp.csr_matrix((np.ones(N - 3), (i, i)), shape=(N, N))
    assert A.todia().data.shape[1] < N
    top = ptt.BandedOperator.from_scipy(A.todia())
    X = np.ones((N, 1))
    assert np.array_equal(top.matmat(torch.as_tensor(X)).numpy(), A @ X)


def test_banded_refuses_complex_and_shapes():
    # complex and half values are served (tests/test_torch_complex.py,
    # tests/test_torch_half_ops.py); integers are refused by name
    assert ptt.BandedOperator((0,), np.ones((1, 4), np.complex64)).dtype \
        == torch.complex64
    assert ptt.BandedOperator.from_scipy(
        sp.identity(4, dtype=np.complex128)).dtype == torch.complex128
    assert ptt.BandedOperator((0,), np.ones((1, 4), np.float16)).dtype \
        == torch.float16
    with pytest.raises(NotImplementedError, match="BandedOperator"):
        ptt.BandedOperator((0,), np.ones((1, 4), np.int16))
    with pytest.raises(NotImplementedError, match="BandedOperator"):
        ptt.BandedOperator.from_scipy(sp.identity(4, dtype=np.int32))
    with pytest.raises(ValueError, match="vals shape"):
        ptt.BandedOperator((0, 1), np.ones((1, 4), np.float32))
    with pytest.raises(ValueError, match="X shape"):
        DK.matmat_reference(torch.ones(1, 4), (0,), torch.ones(5, 1))


def test_banded_cpu_makes_no_launch():
    # on the CPU the wrapper runs the plain version and counts nothing
    vals, X = _case(OFFSETS["wide"], 2, np.float32)
    offs = torch.tensor(OFFSETS["wide"], dtype=torch.int64)
    before = dict(DK.KERNEL_LAUNCHES)
    y = DK.matmat(torch.as_tensor(vals), offs, torch.as_tensor(X))
    yr = DK.matmat(torch.as_tensor(vals), offs, torch.as_tensor(X),
                   adjoint=True)
    assert DK.KERNEL_LAUNCHES == before and DK.LAUNCHES == sum(before.values())
    assert torch.equal(y, DK.matmat_reference(
        torch.as_tensor(vals), OFFSETS["wide"], torch.as_tensor(X)))
    assert torch.equal(yr, DK.rmatmat_reference(
        torch.as_tensor(vals), OFFSETS["wide"], torch.as_tensor(X)))


def test_column_slice_equals_contiguous():
    # a slice of a wider block (rows 24 apart) gives the contiguous result
    offs = OFFSETS["unsorted"]
    vals, _ = _case(offs, 1, np.float64, seed=4)
    W = torch.as_tensor(np.random.default_rng(5).normal(size=(N, 24)))
    op = ptt.BandedOperator(offs, vals)
    for fn in ("matmat", "rmatmat"):
        assert torch.equal(getattr(op, fn)(W[:, 1:3]),
                           getattr(op, fn)(W[:, 1:3].contiguous()))
