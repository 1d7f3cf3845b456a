#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``primme_tpu_torch``) on one card.

Drives the port's two sparse paths once at full size: ``eigsh`` on the
64^3 27-point Laplacian (n = 262,144, 6.86M nonzeros) in random node
order, k=10 smallest, JDQMR_ETol with block 2, basis 24, restart 14, with
the spectrum-verification probe on; first in f32 at tol 1e-5, then on the
same matrix in f64 at tol 1e-10. The format chooser packs the matrix into
the windowed-slot ELL layout and every product goes through the
hand-written kernel of ``primme_tpu_torch/csrc/windowed_ell.cu``: its f32
entry point for the f32 solve, its native FP64 one for the f64 solve.

Phases, each printing its own lines; any failed check raises:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build: compiles both entry points from the checkout's source;
3. f32 kernel against its plain PyTorch version on the packed 64^3
   operator, k in {1, 2, 4, 8}: max |diff| <= 1e-5 * max|y|, and the
   median time of each (21 samples of 10 back-to-back calls between CUDA
   events);
4. f32 solve: the kernel's launch count during the solve, eigenvalues
   within 1e-4 of the closed-form spectrum, every true residual
   (recomputed with the plain version) <= 1.5e-5 * ||A||, probe verified
   and not exhausted, matvec count within 2x of the JAX reference's 1385;
5. f64 kernel: the chooser packs the f64 matrix into an f64 windowed
   operator; the FP64 kernel against the f64 plain version at k in
   {1, 2, 4, 8}: max |diff| <= 1e-13 * max|y|, and both median times;
6. f64 solve: only FP64 launches, at least one per two matvecs;
   eigenvalues within 1e-8 of the closed form, every true residual (the
   f64 plain version) <= 1.5e-10 * ||A||, probe verified and not
   exhausted, matvec count within 2x of the JAX reference's 1876.

Each solve also prints its peak device memory. The second-to-last line is
a JSON record of the kernels and the solves; the last is
``{"ok": true, "device": {...}}``. Run: ``python3 chip_smoke.py``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

GRID = 64            # the problem is the 64^3 grid: n = 262,144
REF_MATVECS = 1385   # the JAX reference's matvecs at GRID (CPU run)
# the JAX reference's matvecs for the f64 solve at GRID, seed 0: its
# eigsh on the f64 matrix (its f64 windowed operator) on the CPU
REF_MATVECS_F64 = 1876


def laplacian27(m, seed):
    """27-point Laplacian 27 I - E(x)E(x)E (E = tridiag(1, 1, 1)) on an
    m^3 grid, rows and columns in a random order from ``seed``; returns
    (A, analytic eigenvalues ascending)."""
    import numpy as np
    import scipy.sparse as sp

    E = sp.diags([np.ones(m - 1), np.ones(m), np.ones(m - 1)], [-1, 0, 1])
    A = (27.0 * sp.identity(m ** 3) - sp.kron(sp.kron(E, E), E)).tocsr()
    p = np.random.default_rng(seed).permutation(m ** 3)
    A = A[p][:, p].tocsr().astype(np.float32)
    lam1 = 1.0 + 2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    ev = np.sort((27.0 - np.einsum("i,j,k->ijk", lam1, lam1, lam1)).ravel())
    return A, ev


def median_ms(fn, reps=21, per=10, warmup=3):
    """Median over ``reps`` samples of the device time of one call: each
    sample times ``per`` back-to-back calls between two CUDA events, so the
    queue stays full and host launch latency does not count."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def solve(ptt, A, seed, tol=1e-5):
    return ptt.eigsh(A, k=10, which="SA", tol=tol,
                     method="PRIMME_JDQMR_ETol", maxBlockSize=2, ncv=24,
                     minRestartSize=14, return_stats=True, seed=seed,
                     device="cuda")


def reset_counts(WE):
    WE.LAUNCHES = 0
    for name in WE.KERNEL_LAUNCHES:
        WE.KERNEL_LAUNCHES[name] = 0


def compare_kernel(WE, op, gen, rel, tag):
    """The kernel against its plain version on ``op`` at k in {1,2,4,8}:
    max |diff| <= rel * max|y|, and the median time of each."""
    import numpy as np
    import torch

    n = op.shape[0]
    per_k = {}
    for k in (1, 2, 4, 8):
        X = torch.randn((n, k), generator=gen, dtype=op.dtype).to(op.device)
        args_ = (op.meta, op.scal, op.offs, op.vals, X)
        y = WE.matmat(*args_)
        yref = WE.matmat_reference(*args_)
        torch.cuda.synchronize()
        err = float((y - yref).abs().max())
        ymax = float(yref.abs().max())
        ms = median_ms(lambda: WE.matmat(*args_))
        plain_ms = median_ms(lambda: WE.matmat_reference(*args_))
        per_k[k] = {"max_abs_err": err, "ymax": ymax, "ms": ms,
                    "plain_ms": plain_ms}
        print(f"[{tag}] k={k} max|y-yref|={err:.3e} (limit "
              f"{rel * ymax:.3e}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms",
              flush=True)
        check(np.isfinite(err) and err <= rel * ymax,
              f"{tag}: kernel disagrees with matmat_reference at k={k}")
    return per_k


def run_solve(ptt, WE, A, op, perm, ev, seed, tol, ev_tol, ref_mv, entry,
              tag):
    """One gated eigsh at ``tol``: only ``entry`` launches, at least one per
    two matvecs; eigenvalues within ``ev_tol`` of the closed form; true
    residuals (the plain product on ``op``) <= 1.5 tol ||A||; probe
    verified and not exhausted; matvecs within 2x of ``ref_mv``."""
    import numpy as np
    import torch

    dev = op.device
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(WE)
    t0 = time.perf_counter()
    w, V, st = solve(ptt, A, seed, tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(WE.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mv = st["num_matvecs"]
    err_ev = float(np.abs(np.sort(w) - ev[:10]).max())
    # true residuals on the card, with the plain product, in the packed order
    Xp = torch.as_tensor(np.ascontiguousarray(V[perm])).to(dev, op.dtype)
    lam = torch.as_tensor(w).to(dev, op.dtype)
    R = WE.matmat_reference(op.meta, op.scal, op.offs, op.vals, Xp) \
        - Xp * lam[None, :]
    res = float(torch.linalg.vector_norm(R, dim=0).max())
    anorm = float(np.abs(ev).max())
    print(f"[{tag}] eigsh wall {wall:.3f} s (solve {st['elapsed_time']:.3f}"
          f" s; the rest is format choice, packing, transfer)  num_matvecs "
          f"{mv}  num_probe_matvecs {st['num_probe_matvecs']}  num_probe_rounds "
          f"{st['num_probe_rounds']}  outer {st['num_outer_iterations']}  "
          f"inner {st['num_inner_iterations']}  restarts {st['num_restarts']}"
          f"  resets {st['num_resets']}", flush=True)
    print(f"[{tag}] kernel launches {launches}  max|eval-analytic| "
          f"{err_ev:.3e}  max residual {res:.3e} (limit "
          f"{1.5 * tol * anorm:.3e})  probe verified {st['probe_verified']} "
          f"exhausted {st['probe_exhausted']}", flush=True)
    print(f"[{tag}] peak device memory {peak} B (max_memory_allocated; "
          f"{before_bytes} B were allocated before the call)", flush=True)
    own = launches.pop(entry)
    check(own >= mv / 2, f"{tag}: only {own} {entry} launches for {mv} "
          "matvecs at block width 2")
    check(not any(launches.values()),
          f"{tag}: another kernel served this solve: {launches}")
    check(err_ev <= ev_tol, f"{tag}: eigenvalue error {err_ev:.3e} > {ev_tol}")
    check(res <= 1.5 * tol * anorm,
          f"{tag}: residual {res:.3e} > {1.5 * tol}*||A||")
    check(st["probe_verified"] == 1 and st["probe_exhausted"] == 0,
          f"{tag}: spectrum verification did not complete")
    check(ref_mv / 2 <= mv <= 2 * ref_mv,
          f"{tag}: {mv} matvecs, not within 2x of the reference's {ref_mv}")
    return {"wall_s": wall, "solve_s": st["elapsed_time"],
            "num_matvecs": mv, "num_probe_matvecs": st["num_probe_matvecs"],
            "num_probe_rounds": st["num_probe_rounds"], "eval_err": err_ev,
            "max_residual": res, "launches": own,
            "peak_bytes": peak, "bytes_before": before_bytes}


def kernel_record(name, replaces, launches, per_k):
    k2 = per_k[2]
    return {"name": name, "route": "cuda",
            "source": "primme_tpu_torch/csrc/windowed_ell.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in per_k.values()),
            "ms": k2["ms"], "plain_ms": k2["plain_ms"],
            "per_k": {str(k): {"ms": v["ms"], "plain_ms": v["plain_ms"],
                               "max_abs_err": v["max_abs_err"]}
                      for k, v in per_k.items()}}


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import primme_tpu_torch as ptt
    from primme_tpu_torch.ops import build
    from primme_tpu_torch.ops import windowed_ell as WE

    # --- 1. device ------------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi, flush=True)

    # --- 2. build ---------------------------------------------------------
    lib = build.library_path("windowed_ell")
    if os.path.exists(lib):
        os.remove(lib)          # always build from the checkout's sources
    t0 = time.perf_counter()
    handle = build.load("windowed_ell")
    entries = list(WE.KERNEL_LAUNCHES)
    for entry in entries:
        getattr(handle, entry)  # raises AttributeError if it is missing
    print(f"[build] windowed_ell.cu -> {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.2f} s; entry points {entries}",
          flush=True)

    # --- 3. f32 kernel against its plain version -------------------------
    A, ev = laplacian27(GRID, args.seed)
    n = A.shape[0]
    t0 = time.perf_counter()
    op, perm = ptt.rcm_banded(A)
    check(isinstance(op, ptt.WindowedELLOperator),
          f"format chooser picked {type(op).__name__}")
    op = op.to(dev)
    print(f"[kernel] n={n} nnz={A.nnz} meta(nrb,S,npad,n,pad,WB)={op.meta} "
          f"chooser {time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    per_k = compare_kernel(WE, op, gen, 1e-5, "kernel")

    # --- 4. f32 solve -------------------------------------------------------
    solve32 = run_solve(ptt, WE, A, op, perm, ev, args.seed, tol=1e-5,
                        ev_tol=1e-4, ref_mv=REF_MATVECS,
                        entry="windowed_ell_spmm_f32", tag="solve")

    # --- 5. f64 kernel against its plain version --------------------------
    A64 = A.astype(np.float64)      # entries 26 and -1: exact in f32
    t0 = time.perf_counter()
    op64, perm64 = ptt.rcm_banded(A64)
    check(isinstance(op64, ptt.WindowedELLOperator)
          and op64.dtype == torch.float64,
          f"format chooser picked {type(op64).__name__} "
          f"({getattr(op64, 'dtype', None)}) for the f64 matrix")
    op64 = op64.to(dev)
    print(f"[kernel64] meta(nrb,S,npad,n,pad,WB)={op64.meta} dtype "
          f"{op64.dtype} chooser {time.perf_counter() - t0:.2f} s",
          flush=True)
    per_k64 = compare_kernel(WE, op64, gen, 1e-13, "kernel64")

    # --- 6. f64 solve -------------------------------------------------------
    solve64 = run_solve(ptt, WE, A64, op64, perm64, ev, args.seed,
                        tol=1e-10, ev_tol=1e-8, ref_mv=REF_MATVECS_F64,
                        entry="windowed_ell_spmm_f64", tag="solve64")

    rec = {"kernels": [
        kernel_record("windowed_ell_spmm_f32",
                      "primme_tpu/ops/pallas_windowed.py:228",
                      solve32["launches"], per_k),
        kernel_record("windowed_ell_spmm_f64",
                      "primme_tpu/ops/pallas_windowed.py:363",
                      solve64["launches"], per_k64)],
        "solve": {**solve32, "f64": solve64}}
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
