"""A plain block polish of approximate eigenvectors, for the control.

LOBPCG on the Rayleigh quotient over ``span[X, K R, P]`` (Knyazev 2001),
the basis orthonormalised by SVQB (Stathopoulos and Wu 2002), with a
Chebyshev-iteration preconditioner (Saad, "Iterative Methods for Sparse
Linear Systems", alg. 12.1) on ``[b / 20, b]``, ``b`` from a power
iteration. It works in the dtype it is given: in float64 it reaches the
configuration's accuracy, and in float32, the control, it cannot. Plain
PyTorch on the operator reference's own product (``ref``, a module of
:mod:`reference`); it imports nothing of the program.
"""

from __future__ import annotations

import torch


def _svqb(S: torch.Tensor, drop: float) -> torch.Tensor:
    """An orthonormal basis of ``span(S)``: the Gram matrix scaled to a
    unit diagonal, its eigenvectors kept where the eigenvalue exceeds
    ``drop`` times the largest."""
    d = torch.linalg.vector_norm(S, dim=0)
    keep = d > 0
    S = S[:, keep] / d[keep][None, :]
    w, V = torch.linalg.eigh(S.T @ S)
    live = w > drop * w[-1]
    return S @ (V[:, live] / torch.sqrt(w[live])[None, :])


def interval(op, n: int, dtype, device, iters: int = 20,
             seed: int = 0) -> tuple:
    """``(b / 20, b)``: ``b`` 1.05 times the last norm of a power
    iteration from a normal start."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, 1), generator=g, dtype=dtype, device=device)
    lam = 1.0
    for _ in range(iters):
        y = op(x)
        lam = float(torch.linalg.vector_norm(y))
        x = y / lam
    b = 1.05 * lam
    return b / 20.0, b


def chebyshev(op, R: torch.Tensor, a: float, b: float,
              degree: int) -> torch.Tensor:
    """``degree`` steps of Chebyshev iteration for ``A Z = R`` from
    ``Z = 0`` on the interval ``[a, b]``: ``degree - 1`` products."""
    theta, delta = (b + a) / 2.0, (b - a) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    D = R / theta
    Z = D.clone()
    for _ in range(degree - 1):
        rho_next = 1.0 / (2.0 * sigma - rho)
        D = rho_next * rho * D + (2.0 * rho_next / delta) * (R - op(Z))
        Z = Z + D
        rho = rho_next
    return Z


def polish(ref, cfg: dict, X0: torch.Tensor, *, tol: float, dtype,
           degree: int = 8, maxiter: int = 200) -> tuple:
    """Polish the ``[n, k]`` block ``X0`` towards the ``k`` smallest pairs
    in ``dtype`` until every residual is at most ``tol * ||A||`` (the
    reference's exact norm) or ``maxiter`` steps have run. Returns ``(evals,
    evecs, steps)`` as tensors on X0's device, ascending."""
    op = lambda V: ref.matmat(cfg, V)  # noqa: E731
    n, k = X0.shape
    anorm = ref.norm(cfg)
    drop = 100.0 * float(torch.finfo(dtype).eps)
    a, b = interval(op, n, dtype, X0.device)
    X = _svqb(X0.to(dtype), drop)[:, :k]
    P = None
    steps = 0
    while True:
        # Rayleigh-Ritz on the block, then the stopping test
        AX = op(X)
        H = X.T @ AX
        lam, Y = torch.linalg.eigh(0.5 * (H + H.T))
        X, AX = X @ Y, AX @ Y
        R = AX - X * lam[None, :]
        if float(torch.linalg.vector_norm(R, dim=0).max()) <= tol * anorm \
                or steps == maxiter:
            break
        steps += 1
        W = chebyshev(op, R, a, b, degree)
        blocks = [X, W] if P is None else [X, W, P]
        S = _svqb(torch.cat(blocks, dim=1), drop)
        S = _svqb(S, drop)
        w, Z = torch.linalg.eigh(S.T @ op(S))
        Z = Z[:, :k]
        Xn = S @ Z
        # the new directions outside the old block
        P = Xn - X @ (X.T @ Xn)
        X = Xn
    return lam, X, steps
