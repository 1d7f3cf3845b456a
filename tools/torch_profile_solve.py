#!/usr/bin/env python3
"""Where the device time of the port's solves goes, from a
``torch.profiler`` trace, on one card.

By default: builds the operator of ``chip_smoke.py`` (the 64^3 27-point
Laplacian in random node order) in f32 and f64 and runs the smoke's
sparse solve on it (k=10 smallest, JDQMR_ETol, block 2, basis 24, restart
14; tol 1e-5 in f32, 1e-10 in f64). With ``--headline``: ``bench.py``'s
solve instead, the 64^3 ``Stencil3DOperator`` with ``JacobiPrecond`` in
f32 through ``solve_eigs`` (``chip_smoke.py`` phase 9). With
``--formats``: the sparse solve on the matrices of ``chip_smoke.py``
phases 11-13 (the chooser's banded, DIA+ELL and ELL branches, f32, tol
1e-5). With ``--northstar``: one iteration of the north star's f64 polish
(``chip_smoke.py`` phase 15: ``refine_step`` on the 128^3 f64 stencil
with ``ChebyshevPrecond.from_operator(A64, degree=8)``, on the closed-form
eigenvectors of the ten smallest eigenvalues plus 1e-6 noise), traced by
``chip_smoke.polish_split``: the f64 stencil, the dense work and the rest,
and the ten largest device items. With ``--complex``: the sparse solve on
the matrices of ``chip_smoke.py`` phases 24-26 (the magnetic Laplacian
through the banded branch in complex64 at tol 1e-5 and complex128 at tol
1e-10, the complex scatter through the ELL one in complex64). With
``--normal``: the ``eigs`` solves of ``chip_smoke.py`` phases 28-30 on
the convection-diffusion operator (``chip_smoke.NORMAL_SOLVES``;
``--normal-solve NAME ...`` only the named ones, ``--normal-grid N``
each at the N^3 grid). Each solve
runs
once to warm up (timed on the host clock up to a synchronise; the
process's first solve also pays the libraries' set-up), then once under
``torch.profiler``. For the profiled solve it prints the host time, the
device-busy total (the device time of every kernel, copy and fill; an
operator's row also carries its kernels' time and is skipped) and its
share of the host time, each hand-written kernel's total, count and mean
and its share of the device total, and the eight largest device items.
``--repo DIR`` imports ``primme_tpu_torch`` from another checkout (say
the parent commit, unpacked), so that two versions are traced in one
call. With ``--stages`` no trace is taken: the profiled solve instead
times the solver's stages on the host clock, each call between two
synchronisations (the window, its projected solve again alone, the inner solve,
``block_ortho``, the new panels of ``H``, restart and reset), and prints
each stage's seconds and calls beside the solve's. ``--plain-gram``
replaces ``core.linalg.gram`` for the run with the plain ``X^H Y`` (in
double for single-precision blocks, as ``gram`` sums), without its
route round a one-column complex product on the card, to measure what
that route saves end to end.

Run: ``python3 tools/torch_profile_solve.py [--repo DIR] [--headline |
--formats | --northstar | --complex | --normal [--normal-solve NAME ...]
[--normal-grid N]] [--stages] [--plain-gram]``.
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


STAGES = {"core.solver": ("prepare_window", "solve_H_normal", "_ortho",
                           "_write_panels", "do_restart", "do_reset"),
          "core.inner": ("jdqmr_inner_solve", "normal_inner_solve")}


def stage_split(label, solve):
    """A warm-up ``solve()``, then one with the solver's stages wrapped in
    synchronised host timers; prints each stage's seconds and calls."""
    import importlib

    import torch

    import primme_tpu_torch as ptt

    acc = {}

    def timed(fn, name):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sec, calls = acc.get(name, (0.0, 0))
            acc[name] = (sec + time.perf_counter() - t0, calls + 1)
            return out
        return wrapper

    solve()
    saved = []
    for modname, names in STAGES.items():
        mod = importlib.import_module("primme_tpu_torch." + modname)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, timed(getattr(mod, name), name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = solve()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(json.dumps({
        "repo": os.path.dirname(os.path.dirname(ptt.__file__)),
        "solve": label, "num_matvecs": st["num_matvecs"],
        "num_outer_iterations": st.get("num_outer_iterations"),
        "solve_s": secs,
        "stages": {name: {"s": sec, "calls": calls}
                   for name, (sec, calls) in acc.items()}}), flush=True)


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
    ap.add_argument("--formats", action="store_true",
                    help="trace the banded, DIA+ELL and ELL solves")
    ap.add_argument("--northstar", action="store_true",
                    help="trace one iteration of the north star's polish")
    ap.add_argument("--complex", action="store_true",
                    help="trace the complex banded and ELL solves")
    ap.add_argument("--normal", action="store_true",
                    help="trace the eigs solves on normal operators")
    ap.add_argument("--normal-solve", nargs="+")
    ap.add_argument("--normal-grid", type=int)
    ap.add_argument("--stages", action="store_true",
                    help="time the solver's stages instead of tracing")
    ap.add_argument("--plain-gram", action="store_true",
                    help="run with the plain X^H Y in place of gram")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_solve: no CUDA device", file=sys.stderr)
        return 2
    run = trace
    if args.stages:
        def run(label, solve, kernels=()):
            stage_split(label, solve)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.repo))
    import primme_tpu_torch as ptt
    from chip_smoke import (GRID, hybrid_matrix, laplacian27,
                            laplacian27_grid, scattered_matrix)
    if args.plain_gram:
        import importlib

        wide = {torch.float32: torch.float64,
                torch.complex64: torch.complex128}

        def plain_gram(X, Y):
            w = wide.get(X.dtype, X.dtype)
            return (X.to(w).mH @ Y.to(w)).to(X.dtype)

        for name in ("linalg", "solver", "inner"):
            mod = importlib.import_module("primme_tpu_torch.core." + name)
            mod.gram = plain_gram

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    if args.northstar:
        import chip_smoke as CS

        m = CS.NS_GRID
        A64 = ptt.Stencil3DOperator(m, m, m, dtype=torch.float64,
                                    device="cuda")
        K = ptt.ChebyshevPrecond.from_operator(A64, degree=CS.NS_DEGREE)
        modes = ((1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1),
                 (2, 1, 2), (1, 2, 2), (3, 1, 1), (1, 3, 1), (1, 1, 3))
        X = CS.stencil_modes(m, modes[:CS.NS_K])
        X = X + 1e-6 * np.random.default_rng(args.seed).standard_normal(
            X.shape)
        for _ in range(3):
            rec = CS.polish_split(ptt, A64, K, X, torch.device("cuda"))
            print(json.dumps({"repo": os.path.dirname(os.path.dirname(
                ptt.__file__)), "solve": "northstar polish iteration",
                **rec}), flush=True)
        return 0
    if args.normal:
        import chip_smoke as CS

        for name, (N, coef, dt, tol, method, fmt) in \
                CS.NORMAL_SOLVES.items():
            if args.normal_solve and name not in args.normal_solve:
                continue
            N = args.normal_grid or N
            A = CS.convection_diffusion(N, coef, dtype=dt)[0]
            op = (ptt.BandedOperator.from_scipy(A) if fmt == "banded"
                  else ptt.aslinearoperator(A)).to("cuda")

            def solve():
                return ptt.eigs(op, tol=tol, method=method, seed=args.seed,
                                return_stats=True, device="cuda",
                                **CS.NORMAL_KWARGS)[2]

            run(f"normal {name} {N}^3", solve, ("ell_spmm", "dia_kernel"))
        return 0
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

        run("headline f32", solve, ("stencil3d_kernel", "jacobi_kernel"))
        return 0
    if args.complex:
        from chip_smoke import (MAG_GRID, complex_scattered_matrix,
                                magnetic_laplacian)

        cases = tuple((f"magnetic {dt}", magnetic_laplacian(
            MAG_GRID, dtype=dt)[0]) for dt in ("complex64", "complex128")) \
            + (("complex ell", complex_scattered_matrix(GRID ** 3,
                                                        args.seed)),)
    elif args.formats:
        cases = (("banded", laplacian27_grid(GRID)[0]),
                 ("hybrid", hybrid_matrix(GRID, args.seed)),
                 ("ell", scattered_matrix(GRID ** 3, args.seed)))
    else:
        A, _ = laplacian27(GRID, args.seed)
        cases = ((np.dtype(dt).name, A.astype(dt))
                 for dt in (np.float32, np.float64))
    for label, M in cases:
        tol = 1e-10 if M.dtype in (np.float64, np.complex128) else 1e-5
        rb = ptt.rcm_banded(M)
        op = (rb[0] if rb is not None else ptt.aslinearoperator(M)).to("cuda")

        def solve():
            return ptt.eigsh(op, k=10, which="SA", tol=tol,
                             method="PRIMME_JDQMR_ETol", maxBlockSize=2,
                             ncv=24, minRestartSize=14, return_stats=True,
                             seed=args.seed, device="cuda")[2]

        run(label, solve, ("ell_spmm", "dia_kernel"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
