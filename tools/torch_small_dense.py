#!/usr/bin/env python3
"""The small dense work of the projected problems on the card: why the
port solves them on the active block and takes the refined extraction's
vectors in an f32 solve from a batched f64 ``eigh`` of the Gram (an f64
solve takes them from a batched SVD, as the reference does).

1. ``chip_smoke.py`` phase 18's JDQR + Jacobi interior solve (f32, tol
   1e-5, the tridiagonal fixture; ``--n``, 1024 by default) four ways:
   as shipped (``solve_H_rr`` on the active ``b x b`` block, its ``eigh``
   in f64), the active block with an f32 ``eigh`` on the card, the
   reference's formulation (one ``mmax x mmax`` f32 ``eigh`` whose
   inactive diagonal holds a sentinel ramp up to ~mmax ||H||), and that
   formulation with its ``eigh`` on the host (LAPACK). Prints each run's
   matvecs, outer iterations and seconds.
2. The refined extraction's batch (``m`` stacked [2m, m] matrices, f32
   and f64, m in {24, 36, 48}): as shipped (``smallest_right_svecs``, on
   the card: the Gram's ``eigh`` for f32, the SVD for f64), cuSOLVER's
   batched SVD on the card under each of ``torch.linalg.svd``'s solver
   choices, and LAPACK's SVD on the host with one thread and with
   torch's default threads.
3. ``chip_smoke.py`` phase 18's refined GD_plusK solve (``--refined-n``,
   512 and 1024 by default) with the shipped extraction and with the
   batch's SVD on the host's LAPACK: matvecs, outer iterations, seconds.

Run on a machine with one card: ``python3 tools/torch_small_dense.py
[--n 1024] [--refined-n 512 1024] [--json FILE]``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def active_f32_solve_H_rr(H, b, target, shifts, shift_idx):
    """``solve_H_rr`` on the active block with cuSOLVER's f32 ``eigh``."""
    import torch
    from primme_tpu_torch.core.linalg import (_embed, real_dtype,
                                              target_sort_keys)

    w, Z = torch.linalg.eigh(H[:b, :b])
    order = torch.argsort(target_sort_keys(w, target, shifts.to(w.dtype),
                                           shift_idx), stable=True)
    return _embed(w[order], Z[:, order], H.shape[0], real_dtype(H.dtype))


def ramped_solve_H_rr(H, b, target, shifts, shift_idx, eigh=None):
    """The reference's ``solve_H_rr``: one ``mmax x mmax`` ``eigh`` with a
    decoupled sentinel ramp on the inactive diagonal, pads found by
    eigenvector support and sorted last."""
    import torch
    from primme_tpu_torch.core.linalg import (ProjectedSolution, col_mask,
                                              real_dtype, target_sort_keys)

    eigh = eigh or torch.linalg.eigh
    mmax = H.shape[0]
    rdt = real_dtype(H.dtype)
    amask = col_mask(mmax, b, H.device)
    Hm = torch.where(amask[:, None] & amask[None, :], H, 0)
    scale = 2.0 * torch.max(torch.abs(Hm)) + 1.0
    ramp = (1.0 + torch.arange(mmax, dtype=rdt, device=H.device)) * scale
    Hm = Hm + torch.diag(torch.where(amask, 0, ramp)).to(H.dtype)
    w, Z = eigh(Hm)
    is_pad = torch.sum(torch.abs(Z) ** 2 * (~amask).to(rdt)[:, None],
                       dim=0) > 0.5
    inf = torch.finfo(rdt).max
    keys = torch.where(is_pad, inf, target_sort_keys(w, target, shifts.to(
        w.dtype), shift_idx))
    order = torch.argsort(keys, stable=True)
    w, Z, is_pad = w[order], Z[:, order], is_pad[order]
    return ProjectedSolution(hvals=torch.where(is_pad, inf, w),
                             hvecs=Z * (~is_pad).to(Z.dtype)[None, :],
                             active=~is_pad)


def host_eigh(M):
    import torch

    w, Z = torch.linalg.eigh(M.cpu())
    return w.to(M.device), Z.to(M.device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--refined-n", type=int, nargs="*", default=[512, 1024])
    ap.add_argument("--json", help="also write the records to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_small_dense: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    import primme_tpu_torch as ptt
    from primme_tpu_torch.core import linalg as L
    from primme_tpu_torch.core import solver as S

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    recs = []
    A = CS.interior_matrix(args.n)
    kw = {**CS.INTERIOR_KWARGS, **CS.INTERIOR_SOLVES["jdqr"]}
    shipped = S.solve_H_rr
    variants = {"active block, f64 eigh (shipped)": shipped,
                "active block, f32 eigh on the card": active_f32_solve_H_rr,
                "ramped mmax, f32 eigh (reference)": ramped_solve_H_rr,
                "ramped, eigh on the host":
                    lambda *a: ramped_solve_H_rr(*a, eigh=host_eigh)}
    for name, fn in variants.items():
        S.solve_H_rr = fn
        try:
            t0 = time.perf_counter()
            w, _, st = ptt.eigsh(A, tol=1e-5, seed=0, device="cuda", **kw)
            torch.cuda.synchronize()
            rec = {"solve": f"JDQR + Jacobi, n={args.n}", "variant": name,
                   "num_matvecs": st["num_matvecs"],
                   "num_outer_iterations": st["num_outer_iterations"],
                   "seconds": time.perf_counter() - t0}
        finally:
            S.solve_H_rr = shipped
        recs.append(rec)
        print(json.dumps(rec), flush=True)

    def timed(f, reps=5):
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    nt = torch.get_num_threads()
    for m in (24, 36, 48):
        for dt in (torch.float32, torch.float64):
            C = torch.randn(m, 2 * m, m, dtype=dt, device="cuda")
            rec = {"svd_batch": f"{m} x [{2 * m}, {m}]", "dtype": str(dt),
                   "card smallest_right_svecs ms": timed(
                       lambda: L.smallest_right_svecs(C))}
            for drv in (None, "gesvd", "gesvdj"):
                rec[f"card {drv or 'default'} ms"] = timed(
                    lambda: torch.linalg.svd(C, full_matrices=False,
                                             driver=drv))
            Ch = C.cpu()
            for th in (1, nt):
                torch.set_num_threads(th)
                rec[f"host {th} thread(s) ms"] = timed(
                    lambda: torch.linalg.svd(Ch, full_matrices=False))
            torch.set_num_threads(nt)
            recs.append(rec)
            print(json.dumps(rec), flush=True)

    shipped_svecs = L.smallest_right_svecs

    def host_svecs(C):
        _, sv, Vh = torch.linalg.svd(C.cpu(), full_matrices=False)
        return (Vh[:, -1, :].conj().T.to(C.device),
                sv[:, -1].to(C.device))

    kw = {**CS.INTERIOR_KWARGS, **CS.INTERIOR_SOLVES["refined"]}
    for n in args.refined_n:
        A = CS.interior_matrix(n)
        for name, fn in (("f64 Gram eigh on the card (shipped)",
                          shipped_svecs),
                         ("SVD on the host, one thread", host_svecs)):
            L.smallest_right_svecs = fn
            torch.set_num_threads(1 if fn is host_svecs else nt)
            try:
                t0 = time.perf_counter()
                w, _, st = ptt.eigsh(A, tol=1e-5, seed=0, device="cuda",
                                     **kw)
                torch.cuda.synchronize()
                rec = {"solve": f"refined GD_plusK, n={n}", "variant": name,
                       "num_matvecs": st["num_matvecs"],
                       "num_outer_iterations": st["num_outer_iterations"],
                       "seconds": time.perf_counter() - t0}
            finally:
                L.smallest_right_svecs = shipped_svecs
                torch.set_num_threads(nt)
            recs.append(rec)
            print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(recs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
