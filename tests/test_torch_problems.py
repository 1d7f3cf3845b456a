"""The test problem of the port's tests: the 27-point Laplacian
27 I - E(x)E(x)E (E = tridiag(1, 1, 1)) on an m^3 grid, rows and columns in
a random node order, the usual stand-in for an unstructured FEM matrix.
Its spectrum is known in closed form and has three-fold clusters.

The other ``test_torch_*`` files import :func:`laplacian27_permuted`, and
:func:`tridiag_fixture`, ``tests/test_eigsh.py``'s tridiagonal fixture;
the tests here hold the closed form against a dense eigensolver, to f64
rounding (1e-12 on eigenvalues of size <= 27)."""

import numpy as np
import pytest
import scipy.sparse as sp


def laplacian27_permuted(m, seed=0):
    """(A f32 CSR in the node order ``seed`` draws, its eigenvalues
    ascending in f64)."""
    E = sp.diags([np.ones(m - 1), np.ones(m), np.ones(m - 1)], [-1, 0, 1])
    A = (27.0 * sp.identity(m ** 3) - sp.kron(sp.kron(E, E), E)).tocsr()
    p = np.random.default_rng(seed).permutation(m ** 3)
    lam1 = 1.0 + 2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    ev = np.sort((27.0 - np.einsum("i,j,k->ijk", lam1, lam1, lam1)).ravel())
    return A[p][:, p].tocsr().astype(np.float32), ev


def tridiag_fixture(n=300):
    """``tests/test_eigsh.py``'s ``tridiag``: diag(linspace(1, 100, n)) +
    0.3 (sub + super) as f64 CSR, with its eigenvalues ascending."""
    d = np.linspace(1, 100, n)
    A = sp.diags([d, 0.3 * np.ones(n - 1), 0.3 * np.ones(n - 1)],
                 [0, 1, -1]).tocsr()
    return A, np.linalg.eigvalsh(A.toarray())


@pytest.mark.parametrize("m", [3, 5])
def test_closed_form_spectrum(m):
    A, ev = laplacian27_permuted(m, seed=m)
    dense = np.linalg.eigvalsh(A.astype(np.float64).toarray())
    assert np.abs(dense - ev).max() <= 1e-12


def test_stencil_and_permutation():
    A, _ = laplacian27_permuted(6, seed=3)
    assert A.dtype == np.float32 and (A != A.T).nnz == 0
    assert np.array_equal(np.sort(A.diagonal()), np.full(216, 26.0))
    # interior nodes have 26 neighbours, corners 7: 4^3 and 8 of them
    deg = np.diff(A.indptr) - 1
    assert (deg == 26).sum() == 64 and (deg == 7).sum() == 8
    assert np.all(A.data[A.data != 26.0] == -1.0)
