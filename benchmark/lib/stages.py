"""The two stages of a configuration, as a PRIMME user's script calls
them through the program's public entries, with the settings of the
configuration file: ``f32_stage`` (``eigsh`` in float32) and ``polish``
(``refine_eigsh`` in float64)."""

from __future__ import annotations


def f32_eigsh(ptt, prob, cfg: dict, v0, device, **extra):
    """``eigsh`` of ``prob.A32`` for the ``k`` smallest pairs from the
    start block ``v0`` (numpy); returns ``(evals, evecs, stats)``."""
    f = cfg["f32_stage"]
    return ptt.eigsh(
        prob.A32, k=prob.k, which="SA", v0=v0, tol=f["tol"],
        OPinv=prob.K32, method=f["method"], ncv=f["ncv"],
        maxBlockSize=f["maxBlockSize"], minRestartSize=f["minRestartSize"],
        locking=f["locking"], maxMatvecs=extra.pop("maxMatvecs",
                                                   f["maxMatvecs"]),
        return_stats=True, device=device, **extra)


def polish(ptt, prob, cfg: dict, X, device, maxiter=None):
    """``refine_eigsh`` of ``prob.A64`` from the block ``X``; returns
    ``(evals, evecs, stats)``."""
    p = cfg["polish"]
    return ptt.refine_eigsh(prob.A64, X, tol=p["tol"], OPinv=prob.K64,
                            maxiter=maxiter or p["maxiter"],
                            return_stats=True, device=device)
