#!/usr/bin/env python3
"""Where the device time of the port's solves goes, from a
``torch.profiler`` trace, on one card.

By default: builds the operator of ``chip_smoke.py`` (the 64^3 27-point
Laplacian in random node order) in f32 and f64 and runs the smoke's
sparse solve on it (k=10 smallest, JDQMR_ETol, block 2, basis 24, restart
14; tol 1e-5 in f32, 1e-10 in f64). With ``--headline``: ``bench.py``'s
solve instead, the 64^3 ``Stencil3DOperator`` with ``JacobiPrecond`` in
f32 through ``solve_eigs`` (``chip_smoke.py`` phase 9). Each solve runs
once to warm up (timed on the host clock up to a synchronise; the
process's first solve also pays the libraries' set-up), then once under
``torch.profiler``. For the profiled solve it prints the host time, the
device-busy total (the device time of every kernel, copy and fill; an
operator's row also carries its kernels' time and is skipped) and its
share of the host time, each hand-written kernel's total, count and mean
and its share of the device total, and the eight largest device items.
``--repo DIR`` imports ``primme_tpu_torch`` from another checkout (say
the parent commit, unpacked), so that two versions are traced in one
call.

Run: ``python3 tools/torch_profile_solve.py [--repo DIR] [--headline]``.
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


def trace(label, solve, kernels):
    """A warm-up ``solve()`` (it returns the stats), then one under the
    profiler; prints the record of the profiled one, with the device time
    of the kernels whose names hold one of ``kernels``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import primme_tpu_torch as ptt

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = solve()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st2 = solve()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    items = [e for e in prof.key_averages()
             if e.device_type != DeviceType.CPU and device_us(e) > 0]
    total = sum(device_us(e) for e in items)
    own = {}
    for name in kernels:
        mine = [e for e in items if name in e.key]
        us, cnt = sum(device_us(e) for e in mine), sum(e.count for e in mine)
        own[name] = {"ms": us / 1e3, "count": cnt,
                     "mean_us": us / max(cnt, 1),
                     "share": us / max(total, 1e-9)}
    top = sorted(items, key=device_us, reverse=True)[:8]
    print(json.dumps({
        "repo": os.path.dirname(os.path.dirname(ptt.__file__)),
        "solve": label,
        "num_matvecs": [st["num_matvecs"], st2["num_matvecs"]],
        "num_probe_matvecs": [st["num_probe_matvecs"],
                              st2["num_probe_matvecs"]],
        "num_probe_rounds": [st["num_probe_rounds"], st2["num_probe_rounds"]],
        "warmup_solve_s": warmup_s, "traced_solve_s": traced_s,
        "device_ms": total / 1e3,
        "device_busy_share": total / 1e6 / traced_s, "kernels": own,
        "top": [[e.key[:80], device_us(e) / 1e3, e.count] for e in top],
    }), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=ROOT,
                    help="checkout to import primme_tpu_torch from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--headline", action="store_true",
                    help="trace bench.py's stencil + Jacobi solve")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_solve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.repo))
    import primme_tpu_torch as ptt
    from chip_smoke import GRID, laplacian27

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    if args.headline:
        from primme_tpu_torch.core.inner import jdqmr_inner_solve
        from primme_tpu_torch.core.solver import solve_eigs

        n = GRID ** 3
        A = ptt.Stencil3DOperator(GRID, GRID, GRID, device="cuda")
        K = ptt.JacobiPrecond(A.diagonal())
        p = ptt.set_method(ptt.Method.JDQMR_ETol, ptt.PrimmeParams(
            n=n, num_evals=10, eps=1e-5, max_basis_size=24,
            max_block_size=2, min_restart_size=14, max_matvecs=16000,
            locking=0), has_precond=True)
        v0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 2)),
                             dtype=torch.float32).to("cuda")

        def solve():
            res = solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32,
                             inner_solve=jdqmr_inner_solve)
            return {"num_matvecs": res.stats.num_matvecs,
                    "num_probe_matvecs": res.stats.num_probe_matvecs,
                    "num_probe_rounds": res.stats.num_probe_rounds}

        trace("headline f32", solve, ("stencil3d_kernel", "jacobi_kernel"))
        return 0
    A, _ = laplacian27(GRID, args.seed)
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-10)):
        op, _ = ptt.rcm_banded(A.astype(dt))
        op = op.to("cuda")

        def solve():
            return ptt.eigsh(op, k=10, which="SA", tol=tol,
                             method="PRIMME_JDQMR_ETol", maxBlockSize=2,
                             ncv=24, minRestartSize=14, return_stats=True,
                             seed=args.seed, device="cuda")[2]

        trace(np.dtype(dt).name, solve, ("ell_spmm",))
    return 0


if __name__ == "__main__":
    sys.exit(main())
