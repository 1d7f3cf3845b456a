"""laplacian7: the program's matrix-free 7-point stencil on the
configuration's ``grid``, made once in set-up, in float32 with the
shift-aware Jacobi preconditioner (the f32 stage) and in float64 with the
Chebyshev polynomial preconditioner (the polish). Its plain reference is
``benchmark/reference/laplacian7.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch


def build(ptt, cfg: dict, device) -> SimpleNamespace:
    """The operators of configuration ``cfg`` on ``device``."""
    nx, ny, nz = cfg["grid"]
    A32 = ptt.Stencil3DOperator(nx, ny, nz, dtype=torch.float32,
                                device=device)
    A64 = ptt.Stencil3DOperator(nx, ny, nz, dtype=torch.float64,
                                device=device)
    pol = cfg["polish"]
    if pol["preconditioner"] != "chebyshev":
        raise ValueError(f"unknown polish preconditioner "
                         f"{pol['preconditioner']!r}")
    K64 = ptt.ChebyshevPrecond.from_operator(A64, degree=pol["degree"])
    if cfg["f32_stage"]["preconditioner"] != "jacobi":
        raise ValueError(f"unknown f32 preconditioner "
                         f"{cfg['f32_stage']['preconditioner']!r}")
    K32 = ptt.JacobiPrecond(A32.diagonal())
    return SimpleNamespace(n=nx * ny * nz, grid=(nx, ny, nz), k=cfg["k"],
                           A32=A32, K32=K32, A64=A64, K64=K64)
