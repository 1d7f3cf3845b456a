#!/usr/bin/env python3
"""The north star on the card: the 128^3 7-point Laplacian (n =
2,097,152), the k smallest eigenpairs to a true residual <= tol * ||A||.

The port's counterpart of ``benches/northstar.py``, with its two stages:

1. f32: ``solve_eigs`` with JDQMR_ETol and the shift-aware Jacobi
   preconditioner on ``Stencil3DOperator`` (the stencil and Jacobi
   kernels), ``v0`` from ``default_rng(0)``. For k <= 20 a windowed
   soft-locking basis (basis 24, block 2, restart k+4, locking off); for
   larger k hard locking with basis 64 and block 4 (BASELINE config 4 is
   ``--k 100``);
2. f64: ``refine_eigsh`` on the f64 ``Stencil3DOperator`` with
   ``ChebyshevPrecond.from_operator(A64, degree=8)``, in native FP64 on
   the card (the reference polishes on the host).

Then the bench's check: every eigenvalue within 1e-10 of the closed form,
and the largest true residual (recomputed here in f64 with the stencil's
plain version, independent of the polish's own report) <= tol * ||A||,
with ||A|| = 12, the closed form's bound. Prints the stages' seconds and
counts, the peak device memory and a JSON record, and exits 1 when the
check fails. ``chip_smoke.py`` phase 15 runs the same stages.

Run: ``python3 tools/torch_northstar.py [--nx 128] [--k 10] [--tol 1e-10]
[--json FILE]``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANORM = 12.0      # ||A|| <= 12 for the 7-point Laplacian (closed form)


def block_size(k):
    """The f32 stage's block: 2 for the windowed basis (k <= 20), 4 with
    hard locking."""
    return 2 if k <= 20 else 4


def f32_stage(ptt, nx, k, device):
    """``benches/northstar.py``'s f32 solve; returns ``(EigsResult,
    seconds)`` (the time ends in a device sync)."""
    import numpy as np
    import torch
    from primme_tpu_torch.core.inner import jdqmr_inner_solve
    from primme_tpu_torch.core.solver import solve_eigs

    n = nx ** 3
    A32 = ptt.Stencil3DOperator(nx, nx, nx, dtype=torch.float32,
                                device=device)
    K32 = ptt.JacobiPrecond(A32.diagonal())
    blk = block_size(k)
    if k <= 20:
        p = ptt.PrimmeParams(n=n, num_evals=k, eps=1e-5, max_basis_size=24,
                             max_block_size=blk, min_restart_size=k + 4,
                             max_matvecs=60000, locking=0)
    else:
        p = ptt.PrimmeParams(n=n, num_evals=k, eps=1e-5, max_basis_size=64,
                             max_block_size=blk, max_matvecs=120000,
                             locking=1)
    p = ptt.set_method(ptt.Method.JDQMR_ETol, p, has_precond=True)
    v0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, blk)),
                         dtype=torch.float32).to(device)
    _sync(device)
    t0 = time.perf_counter()
    res = solve_eigs(A32, p, K=K32, v0=v0, dtype=torch.float32,
                     inner_solve=jdqmr_inner_solve)
    _sync(device)
    return res, time.perf_counter() - t0


def polish(ptt, nx, X32, tol, device, degree=8, progress=0):
    """The f64 polish of ``X32``; returns ``(evals, evecs, stats, the f64
    operator, the preconditioner, seconds)``; the time covers the
    preconditioner's interval estimate and ends in a device sync."""
    import torch
    from primme_tpu_torch.refine import refine_eigsh

    _sync(device)
    t0 = time.perf_counter()
    A64 = ptt.Stencil3DOperator(nx, nx, nx, dtype=torch.float64,
                                device=device)
    K64 = ptt.ChebyshevPrecond.from_operator(A64, degree=degree)
    ev, X, st = refine_eigsh(A64, X32, tol=tol, OPinv=K64, maxiter=200,
                             return_stats=True, device=device,
                             progress=progress)
    _sync(device)
    return ev, X, st, A64, K64, time.perf_counter() - t0


def check(nx, k, ev, X, device):
    """Largest |lambda - closed form| and the largest true residual
    ||A x - lambda x|| in f64 through the stencil's plain version."""
    import numpy as np
    import torch
    from primme_tpu_torch.ops import stencil3d as ST

    ax = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    m = min(nx, max(4, int(np.ceil(k ** (1 / 3))) + 3))
    lam = np.sort((ax[:m, None, None] + ax[None, :m, None]
                   + ax[None, None, :m]).ravel())[:k]
    err = float(np.abs(np.sort(ev) - lam).max())
    Xt = torch.as_tensor(X, dtype=torch.float64, device=device)
    R = ST.matmat_reference(Xt, nx, nx, nx) \
        - Xt * torch.as_tensor(ev, dtype=torch.float64, device=device)
    true_res = float(torch.linalg.vector_norm(R, dim=0).max())
    return err, true_res


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one)")
    ap.add_argument("--json", help="also write the record to this file")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, ROOT)
    import primme_tpu_torch as ptt
    from primme_tpu_torch.operators import default_device

    dev = default_device(args.device, "torch_northstar")
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True).stdout.strip(),
            flush=True)
        torch.cuda.reset_peak_memory_stats()
    res, t32 = f32_stage(ptt, args.nx, args.k, dev)
    st32 = res.stats
    print(f"f32 stage: {t32:.3f} s  matvecs {st32.num_matvecs} (probe "
          f"{st32.num_probe_matvecs}, rounds {st32.num_probe_rounds}, "
          f"verified {st32.probe_verified})  outer "
          f"{st32.num_outer_iterations}", flush=True)
    ev, X, st, _, K64, t64 = polish(ptt, args.nx, res.evecs, args.tol, dev,
                                    progress=5 if args.k > 20 else 0)
    err, true_res = check(args.nx, args.k, ev, X, dev)
    ok = err < 1e-10 and true_res <= args.tol * ANORM
    rec = {"nx": args.nx, "k": args.k, "tol": args.tol, "f32_s": t32,
           "f32_num_matvecs": st32.num_matvecs,
           "f32_num_probe_matvecs": st32.num_probe_matvecs,
           "f32_probe_verified": st32.probe_verified,
           "polish_s": t64, "num_refine_iters": st["num_refine_iters"],
           "chebyshev_interval": [float(K64.a), float(K64.b)],
           "anorm_estimate": st["anorm_estimate"],
           "max_resnorm": float(st["resnorms"].max()),
           "max_true_residual": true_res, "eval_err": err, "ok": ok}
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"f64 polish ({dev.type}): {t64:.3f} s  iterations "
          f"{st['num_refine_iters']}  interval [{float(K64.a):.6g}, "
          f"{float(K64.b):.6g}]", flush=True)
    print(f"eval_err_vs_analytic: {err:.3e}  max true residual "
          f"{true_res:.3e} (limit {args.tol * ANORM:.3e})  ok: {ok}"
          + (f"  peak device memory {rec['peak_bytes']} B"
             if dev.type == "cuda" else ""), flush=True)
    print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
