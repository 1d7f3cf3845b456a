"""The comparison that decides ``correct`` for answers that are
eigenpairs.

Each call of the measured window returns ``(evals, evecs)``: numpy arrays
of the ``k`` eigenvalues and their ``[n, k]`` float64 eigenvectors. Three
numbers are compared, each the largest over the calls, each against the
limit the configuration file states (``limits``):

* ``eval_err``: ``max |lambda_j - lambda_j(exact)|`` over the sorted
  values, the operator reference's ``k`` smallest;
* ``res_rel``: ``max_j ||A x_j - lambda_j x_j|| / ||A||``, the residual
  recomputed here with the reference's own product in float64 and its
  exact norm;
* ``ortho_err``: ``max |X^T X - I|``.

The operator reference is the file of ``reference/`` that the
configuration's ``operator`` names. A call whose arrays have the wrong
shape, or hold a value that is not finite, fails outright.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("eval_err", "res_rel", "ortho_err")


def residual_norms(ref, cfg: dict, X: torch.Tensor, lam: torch.Tensor,
                   block: int = 16) -> torch.Tensor:
    """``||A x_j - lam_j x_j||_2`` for every column, in X's dtype, a
    ``block`` of columns at a time so that the temporaries stay small."""
    out = []
    for c in range(0, X.shape[1], block):
        Xb = X[:, c:c + block]
        R = ref.matmat(cfg, Xb) - Xb * lam[c:c + block][None, :]
        out.append(torch.linalg.vector_norm(R, dim=0))
    return torch.cat(out)


def ortho_error(X: torch.Tensor) -> float:
    """``max |X^T X - I|`` over the entries."""
    G = X.T @ X
    G -= torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return float(G.abs().max())


def measure(ref, cfg: dict, evals, evecs, k: int, device):
    """The three numbers of one call's answer; None when its arrays do
    not have the shapes ``[k]`` and ``[n, k]``."""
    n = ref.size(cfg)
    ev = np.asarray(evals, dtype=np.float64)
    if ev.shape != (k,) or np.shape(evecs) != (n, k):
        return None
    X = torch.as_tensor(np.asarray(evecs), device=device).to(torch.float64)
    lam = torch.as_tensor(ev, device=device)
    exact = ref.smallest(cfg, k)
    out = {"eval_err": float(np.max(np.abs(np.sort(ev) - exact))),
           "res_rel": float(residual_norms(ref, cfg, X, lam).max())
           / ref.norm(cfg),
           "ortho_err": ortho_error(X)}
    del X
    return out


def passes(numbers: dict, limits: dict) -> bool:
    """Every number finite and at most its limit."""
    return all(math.isfinite(numbers[m]) and numbers[m] <= limits[m]
               for m in NUMBERS)


def compare(ref, cfg: dict, answers, device) -> dict:
    """Judge every answer against ``cfg["limits"]``. Returns ``{"numbers":
    {name: {"value", "limit"}}, "failed": count, "judged": count}``; a
    number's value is the largest over the answers (NaN where one was not
    finite, infinity where an answer had the wrong shape)."""
    k, limits = cfg["k"], cfg["limits"]
    worst = dict.fromkeys(NUMBERS, 0.0)
    failed = 0
    for evals, evecs in answers:
        got = measure(ref, cfg, evals, evecs, k, device)
        if got is None:
            got = dict.fromkeys(NUMBERS, math.inf)
        if not passes(got, limits):
            failed += 1
        for m in NUMBERS:
            # a number that is not finite stays the worst
            if math.isfinite(worst[m]):
                v = got[m]
                worst[m] = v if not math.isfinite(v) else max(worst[m], v)
    return {"numbers": {m: {"value": worst[m], "limit": limits[m]}
                        for m in NUMBERS},
            "failed": failed, "judged": len(answers)}
