"""The port's DenseOperator, DiagonalOperator and aslinearoperator's dense
branches against the JAX package's on the same numpy inputs.

Tolerances: a dense product sums in another order than XLA's (both in full
precision, TF32 off), so it is held to 8 eps(dtype) n max|A| max|X|; the
diagonal scale and the densified entries are exact."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from primme_tpu import operators as JO
import primme_tpu_torch as ptt

DTYPES = [np.float32, np.float64]


def _tdt(dtype):
    return getattr(torch, np.dtype(dtype).name)


def _close(y, yj, A, X):
    dtype = y.dtype
    tol = 8 * np.finfo(dtype).eps * A.shape[1] * np.abs(A).max() \
        * np.abs(X).max()
    return y.dtype == yj.dtype and np.abs(y - yj).max() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3])
def test_dense_operator_matches_reference(k, dtype):
    rng = np.random.default_rng(k)
    A = rng.normal(size=(40, 40)).astype(dtype)
    X = rng.normal(size=(40, k)).astype(dtype)
    jop, top = JO.DenseOperator(A), ptt.DenseOperator(A)
    assert top.shape == jop.shape and top.dtype == _tdt(dtype)
    for fn in ("matmat", "rmatmat"):
        y = getattr(top, fn)(torch.as_tensor(X)).numpy()
        assert _close(y, np.asarray(getattr(jop, fn)(jnp.asarray(X))), A, X)
    assert np.array_equal(top.diagonal().numpy(), np.asarray(jop.diagonal()))
    # the array is the operator's own: a later change of A does not reach it
    A[0, 0] = 1e3
    assert top.A[0, 0] != 1e3


@pytest.mark.parametrize("dtype", DTYPES)
def test_diagonal_operator_matches_reference(dtype):
    rng = np.random.default_rng(7)
    d = rng.normal(size=50).astype(dtype)
    X = rng.normal(size=(50, 2)).astype(dtype)
    jop, top = JO.DiagonalOperator(jnp.asarray(d)), ptt.DiagonalOperator(d)
    assert top.shape == jop.shape and top.dtype == _tdt(dtype)
    for fn in ("matmat", "rmatmat"):
        y = getattr(top, fn)(torch.as_tensor(X)).numpy()
        assert np.array_equal(y, np.asarray(getattr(jop, fn)(jnp.asarray(X))))
    assert np.array_equal(top.diagonal().numpy(), d)


@pytest.mark.parametrize("kind", ["numpy", "torch", "scipy_csr", "scipy_coo"])
def test_aslinearoperator_dense_branches(kind):
    rng = np.random.default_rng(3)
    S = sp.random(60, 60, density=0.1, random_state=4, dtype=np.float64)
    S = (S + S.T).tocsr()
    A = {"numpy": S.toarray(), "torch": torch.as_tensor(S.toarray()),
         "scipy_csr": S, "scipy_coo": S.tocoo()}[kind]
    top = ptt.aslinearoperator(A)
    jop = JO.aslinearoperator(A.numpy() if kind == "torch" else A)
    assert isinstance(top, ptt.DenseOperator)
    assert isinstance(jop, JO.DenseOperator)
    assert np.array_equal(top.A.numpy(), np.asarray(jop.A))
    X = rng.normal(size=(60, 2))
    assert _close(top.matmat(torch.as_tensor(X)).numpy(),
                  np.asarray(jop.matmat(jnp.asarray(X))), S.toarray(), X)


def test_aslinearoperator_refuses_what_it_does_not_port():
    # a 1-D array is no operator (the reference's ValueError); a large
    # sparse matrix is an ELLOperator and a scipy LinearOperator a
    # FunctionOperator, as in the reference, complex and half values too;
    # a type the port does not serve (integers) names the format
    import scipy.sparse.linalg as spla

    with pytest.raises(ValueError, match="2-D"):
        ptt.aslinearoperator(np.ones(5))
    big = sp.identity(8193, format="csr", dtype=np.float32)
    assert isinstance(ptt.aslinearoperator(big), ptt.ELLOperator)
    assert ptt.aslinearoperator(big.astype(np.complex64)).dtype \
        == torch.complex64
    with pytest.raises(NotImplementedError, match="ELLOperator"):
        ptt.aslinearoperator(big.astype(np.int32))
    assert isinstance(ptt.aslinearoperator(spla.aslinearoperator(np.eye(3))),
                      ptt.FunctionOperator)
    f = ptt.aslinearoperator(spla.aslinearoperator(np.eye(3) * 1j))
    assert f.dtype == torch.complex128
    assert torch.equal(f.matmat(torch.ones(3, 1, dtype=torch.complex128)),
                       torch.full((3, 1), 1j, dtype=torch.complex128))
    h = ptt.aslinearoperator(spla.aslinearoperator(
        np.eye(3, dtype=np.float16)))
    assert h.dtype == torch.float16
    assert torch.equal(h.matmat(torch.ones(3, 1, dtype=torch.float16)),
                       torch.ones(3, 1, dtype=torch.float16))
    with pytest.raises(NotImplementedError, match="FunctionOperator"):
        ptt.aslinearoperator(spla.aslinearoperator(
            np.eye(3, dtype=np.int16)))


def test_dense_eigsh_on_cpu_finds_smallest():
    # eigsh on a small numpy matrix: aslinearoperator -> DenseOperator
    A = np.diag(np.arange(1.0, 101.0))
    w = ptt.eigsh(A, k=3, which="SA", tol=1e-8, device="cpu",
                  return_eigenvectors=False)
    assert np.abs(np.sort(w) - [1.0, 2.0, 3.0]).max() <= 1e-6
