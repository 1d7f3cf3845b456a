"""The plain reference of the 7-point Dirichlet Laplacian (the operator
``laplacian7`` of a configuration file, on its ``grid``).

The operator is ``A = 6 I - (sum of the six grid neighbours)`` on an
``nx x ny x nz`` grid of unit spacing with zero values outside it; row
``(i * ny + j) * nz + l`` is grid point ``(i, j, l)``. Its eigenpairs are
known in closed form: ``lambda(p, q, r) = a_x(p) + a_y(q) + a_z(r)`` with
``a_m(p) = 2 - 2 cos(p pi / (m + 1))``, ``p = 1..m``, and the vector is
the product of the axes' sines ``sin(p pi i / (m + 1))``.

The functions an operator's reference gives (:mod:`reference`) take the
configuration: ``size``, ``smallest``, ``norm`` and ``matmat``, and, for
inputs made in the eigenbasis, ``mode_values`` and ``synthesize`` (the
3-D sine transform; :func:`vectors_on` builds the same vectors as
products of sines, for the tests). Everything here is plain NumPy
or PyTorch written for the benchmark. It imports nothing of the program
under test and takes nothing it made.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def axis_values(m: int) -> np.ndarray:
    """The eigenvalues ``2 - 2 cos(p pi / (m + 1))``, ``p = 1..m``, of the
    1-D second difference on ``m`` points, ascending."""
    return 2.0 - 2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))


def modes(grid, k: int):
    """``(values, pqr)``: the ``k`` smallest eigenvalues on ``grid``
    (``(nx, ny, nz)``), ascending, each repeated as often as it occurs,
    and their modes ``[k, 3]`` (1-based). The ``k`` smallest sums use at
    most the ``k`` smallest values of each axis, so the search runs over
    ``min(m, k)`` values an axis; ties keep the modes' order."""
    ax = [axis_values(m)[:min(m, k)] for m in grid]
    sums = (ax[0][:, None, None] + ax[1][None, :, None]
            + ax[2][None, None, :]).ravel()
    order = np.argsort(sums, kind="stable")[:k]
    pqr = np.stack(np.unravel_index(order, [len(a) for a in ax]), axis=1)
    return sums[order], pqr + 1


def smallest_on(grid, k: int) -> np.ndarray:
    """The ``k`` smallest eigenvalues on ``grid``, ascending."""
    return modes(grid, k)[0]


def largest_on(grid) -> float:
    """``||A||_2``, the largest eigenvalue, in closed form."""
    return float(sum(axis_values(m)[-1] for m in grid))


def cluster_cut(grid, k: int, rtol: float = 1e-12) -> bool:
    """True when the ``k``-th and ``(k+1)``-th eigenvalues are equal, so
    that a set of ``k`` pairs holds part of a degenerate cluster."""
    n = int(np.prod(grid))
    if k >= n:
        return False
    lam = smallest_on(grid, k + 1)
    return abs(lam[k] - lam[k - 1]) <= rtol * max(abs(lam[k]), 1.0)


def matmat_on(X: torch.Tensor, grid) -> torch.Tensor:
    """``A X`` for an ``[n, k]`` block, computed in X's dtype: six times
    each point less each neighbour that lies inside the grid."""
    nx, ny, nz = grid
    k = X.shape[1]
    G = X.reshape(nx, ny, nz, k)
    Y = 6.0 * G
    Y[1:] -= G[:-1]
    Y[:-1] -= G[1:]
    Y[:, 1:] -= G[:, :-1]
    Y[:, :-1] -= G[:, 1:]
    Y[:, :, 1:] -= G[:, :, :-1]
    Y[:, :, :-1] -= G[:, :, 1:]
    return Y.reshape(-1, k)


def vectors_on(grid, k: int, device, dtype=torch.float64):
    """``(values, Q)``: the ``k`` smallest eigenvalues (numpy) and their
    orthonormal eigenvectors ``[n, k]`` in ``dtype`` on ``device``, each
    the product of its mode's three sines."""
    lam, pqr = modes(grid, k)
    axes = []
    for d, m in enumerate(grid):
        i = torch.arange(1, m + 1, dtype=torch.float64, device=device)
        p = torch.as_tensor(pqr[:, d], dtype=torch.float64, device=device)
        axes.append(torch.sin(i[:, None] * p[None, :] * (math.pi / (m + 1)))
                    * math.sqrt(2.0 / (m + 1)))
    Q = torch.einsum("ic,jc,lc->ijlc", *axes).reshape(-1, k)
    return lam, Q.to(dtype)


def axis_basis(m: int, device) -> torch.Tensor:
    """The orthonormal sine basis ``S[i, p] = sqrt(2 / (m + 1)) sin(p i pi
    / (m + 1))`` of one axis, ``[m, m]`` float64; symmetric, so its own
    inverse."""
    i = torch.arange(1, m + 1, dtype=torch.float64, device=device)
    return torch.sin(i[:, None] * i[None, :] * (math.pi / (m + 1))) \
        * math.sqrt(2.0 / (m + 1))


def mode_values(cfg: dict, device) -> torch.Tensor:
    """The eigenvalue of every mode ``(p, q, r)``, ``[n]`` float64 in the
    rows' order ``(p * ny + q) * nz + r``."""
    a = [torch.as_tensor(axis_values(m), device=device) for m in cfg["grid"]]
    return (a[0][:, None, None] + a[1][None, :, None]
            + a[2][None, None, :]).reshape(-1)


def synthesize(cfg: dict, coef: torch.Tensor) -> torch.Tensor:
    """The vectors ``[n, c]`` whose coordinates in the eigenbasis are
    ``coef`` (``[n, c]``, rows in :func:`mode_values`' order): the sine
    transform along each axis, in coef's dtype."""
    nx, ny, nz = cfg["grid"]
    c = coef.shape[1]
    G = coef.reshape(nx, ny, nz, c)
    for axis, m in enumerate((nx, ny, nz)):
        S = axis_basis(m, coef.device).to(coef.dtype)
        G = torch.tensordot(S, G, dims=([1], [axis])).movedim(0, axis)
    return G.reshape(-1, c)


def size(cfg: dict) -> int:
    return int(np.prod(cfg["grid"]))


def smallest(cfg: dict, k: int) -> np.ndarray:
    return smallest_on(tuple(cfg["grid"]), k)


def norm(cfg: dict) -> float:
    return largest_on(tuple(cfg["grid"]))


def matmat(cfg: dict, X: torch.Tensor) -> torch.Tensor:
    return matmat_on(X, tuple(cfg["grid"]))

