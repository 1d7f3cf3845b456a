#!/usr/bin/env python3
"""Where the device time of the port's sparse eigsh goes, from a
``torch.profiler`` trace, on one card.

Builds the operator of ``chip_smoke.py`` (the 64^3 27-point Laplacian in
random node order) in f32 and f64 and runs the smoke's solve on it (k=10
smallest, JDQMR_ETol, block 2, basis 24, restart 14; tol 1e-5 in f32,
1e-10 in f64): once to warm up (timed on the host clock up to a
synchronise; the process's first solve also pays the libraries' set-up),
then once under ``torch.profiler``. For the profiled solve it
prints the device-busy total (the device time of every kernel, copy and
fill; an operator's row also carries its kernels' time and is skipped),
the SpMM kernels' total, count and mean, their share of the total, and
the eight largest device items. ``--repo DIR`` imports
``primme_tpu_torch`` from another checkout (say the parent commit,
unpacked), so that two versions are traced in one call.

Run: ``python3 tools/torch_profile_solve.py [--repo DIR]``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_us(e):
    """An event's self device time in microseconds."""
    t = getattr(e, "self_device_time_total", None)
    return t if t is not None else e.self_cuda_time_total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=ROOT,
                    help="checkout to import primme_tpu_torch from")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_solve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.repo))
    import primme_tpu_torch as ptt
    from primme_tpu_torch.ops import windowed_ell as WE
    from chip_smoke import GRID, laplacian27

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    A, _ = laplacian27(GRID, args.seed)
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-10)):
        op, _ = ptt.rcm_banded(A.astype(dt))
        op = op.to("cuda")

        def solve():
            return ptt.eigsh(op, k=10, which="SA", tol=tol,
                             method="PRIMME_JDQMR_ETol", maxBlockSize=2,
                             ncv=24, minRestartSize=14, return_stats=True,
                             seed=args.seed, device="cuda")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, st = solve()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        before = sum(WE.KERNEL_LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, st2 = solve()
            torch.cuda.synchronize()
        launches = sum(WE.KERNEL_LAUNCHES.values()) - before
        items = [e for e in prof.key_averages()
                 if e.device_type != DeviceType.CPU and device_us(e) > 0]
        total = sum(device_us(e) for e in items)
        spmm = [e for e in items if "ell_spmm" in e.key]
        spmm_us = sum(device_us(e) for e in spmm)
        spmm_n = sum(e.count for e in spmm)
        top = sorted(items, key=device_us, reverse=True)[:8]
        print(json.dumps({
            "repo": os.path.abspath(args.repo), "dtype": np.dtype(dt).name,
            "num_matvecs": [st["num_matvecs"], st2["num_matvecs"]],
            "spmm_launches": launches, "warmup_solve_s": warmup_s,
            "device_ms": total / 1e3, "spmm_ms": spmm_us / 1e3,
            "spmm_count": spmm_n,
            "spmm_mean_us": spmm_us / max(spmm_n, 1),
            "spmm_share": spmm_us / max(total, 1e-9),
            "top": [[e.key[:80], device_us(e) / 1e3, e.count] for e in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
