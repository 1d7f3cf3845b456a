"""The plain reference against scipy at small grids, and the comparison
that decides ``correct``."""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from reference import eigenpairs, laplacian7


def assembled(grid):
    """The 7-point Dirichlet Laplacian as a scipy matrix, rows in the
    reference's order, built from 1-D second differences."""
    def d2(m):
        return sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                        [-1, 0, 1])
    nx, ny, nz = grid
    I = sp.identity
    return (sp.kron(sp.kron(d2(nx), I(ny)), I(nz))
            + sp.kron(sp.kron(I(nx), d2(ny)), I(nz))
            + sp.kron(sp.kron(I(nx), I(ny)), d2(nz))).tocsr()


@pytest.mark.parametrize("grid", [(5, 4, 3), (6, 6, 6), (7, 3, 5)])
def test_spectrum_matches_dense_eigh(grid):
    A = assembled(grid).toarray()
    lam = np.linalg.eigvalsh(A)
    n = A.shape[0]
    np.testing.assert_allclose(laplacian7.smallest_on(grid, n), lam,
                               rtol=0, atol=1e-12)
    assert laplacian7.largest_on(grid) == pytest.approx(lam[-1], abs=1e-12)


def test_smallest_matches_scipy_eigsh_at_12():
    grid = (12, 12, 12)
    lam = spla.eigsh(assembled(grid), k=20, sigma=0, which="LM",
                     return_eigenvectors=False)
    np.testing.assert_allclose(laplacian7.smallest_on(grid, 20), np.sort(lam),
                               rtol=0, atol=1e-11)


def test_clusters_at_128():
    g = (128, 128, 128)
    assert not laplacian7.cluster_cut(g, 10)        # 1 + 3 + 3 + 3
    assert laplacian7.cluster_cut(g, 100)           # 4 of a cluster of 6
    lam = laplacian7.smallest_on(g, 102)
    assert np.ptp(lam[96:102]) < 1e-14 and lam[102 - 1] - lam[95] > 1e-4


@pytest.mark.parametrize("grid", [(4, 5, 6), (8, 8, 8)])
def test_matmat_matches_scipy(grid):
    A = assembled(grid)
    X = np.random.default_rng(1).normal(size=(A.shape[0], 3))
    Y = laplacian7.matmat_on(torch.as_tensor(X), grid).numpy()
    np.testing.assert_allclose(Y, A @ X, rtol=0, atol=1e-12)


@pytest.mark.parametrize("grid, k", [((9, 8, 7), 12), ((6, 6, 6), 20)])
def test_exact_vectors_are_eigenpairs(grid, k):
    lam, Q = laplacian7.vectors_on(grid, k, "cpu")
    np.testing.assert_allclose(lam, laplacian7.smallest_on(grid, k),
                               rtol=0, atol=1e-14)
    R = laplacian7.matmat_on(Q, grid) - Q * torch.as_tensor(lam)[None, :]
    assert float(R.abs().max()) < 1e-13
    assert eigenpairs.ortho_error(Q) < 1e-13


def pairs(grid, k):
    lam, Q = laplacian7.vectors_on(grid, k, "cpu")
    return lam, Q.numpy()


def cfg_of(grid, k):
    return {"grid": list(grid), "k": k,
            "limits": {"eval_err": 1e-10, "res_rel": 1e-10,
                       "ortho_err": 1e-10}}


def test_exact_pairs_pass_and_perturbed_fail():
    grid, k = (9, 8, 7), 4
    cfg = cfg_of(grid, k)
    lam, X = pairs(grid, k)
    got = eigenpairs.measure(laplacian7, cfg, lam, X, k, "cpu")
    assert eigenpairs.passes(got, cfg["limits"]), got
    assert got["res_rel"] < 1e-14 and got["ortho_err"] < 1e-14
    bad = lam.copy()
    bad[2] += 1e-8
    assert not eigenpairs.passes(
        eigenpairs.measure(laplacian7, cfg, bad, X, k, "cpu"), cfg["limits"])
    Xb = X.copy()
    Xb[5, 1] += 1e-7
    got = eigenpairs.measure(laplacian7, cfg, lam, Xb, k, "cpu")
    assert not eigenpairs.passes(got, cfg["limits"])
    assert got["res_rel"] > 1e-10


def test_compare_counts_failures_and_keeps_the_worst():
    grid, k = (6, 6, 6), 4
    cfg = cfg_of(grid, k)
    lam, X = pairs(grid, k)
    nan = lam.copy()
    nan[0] = np.nan
    out = eigenpairs.compare(
        laplacian7, cfg, [(lam, X), (lam[:3], X[:, :3]), (nan, X), (lam, X)],
        "cpu")
    assert out["judged"] == 4 and out["failed"] == 2
    assert math.isinf(out["numbers"]["res_rel"]["value"]) or \
        math.isnan(out["numbers"]["res_rel"]["value"])
    assert out["numbers"]["eval_err"]["limit"] == 1e-10
    ok = eigenpairs.compare(laplacian7, cfg, [(lam, X)] * 2, "cpu")
    assert ok["failed"] == 0
    assert ok["numbers"]["res_rel"]["value"] < 1e-14


@pytest.mark.parametrize("grid", [(6, 5, 4), (7, 7, 7)])
def test_sine_transform_gives_the_exact_vectors(grid):
    cfg = {"grid": list(grid)}
    lam_all = laplacian7.mode_values(cfg, "cpu")
    k = 9
    lam, Q = laplacian7.vectors_on(grid, k, "cpu")
    order = torch.argsort(lam_all, stable=True)[:k]
    np.testing.assert_allclose(lam_all[order].numpy(), lam, rtol=0,
                               atol=1e-14)
    C = torch.zeros((lam_all.numel(), k), dtype=torch.float64)
    C[order, torch.arange(k)] = 1.0
    X = laplacian7.synthesize(cfg, C)
    # equal up to a sign a column, and up to a turn inside a cluster
    P = (X.T @ Q).abs()
    torch.testing.assert_close(torch.linalg.svdvals(X.T @ Q),
                               torch.ones(k, dtype=torch.float64))
    R = laplacian7.matmat_on(X, grid) - X * torch.as_tensor(lam)[None, :]
    assert float(R.abs().max()) < 1e-13 and float(P.max()) <= 1 + 1e-12
