#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``primme_tpu_torch``) on one card.

Drives the port's two sparse paths once at full size: ``eigsh`` on the
64^3 27-point Laplacian (n = 262,144, 6.86M nonzeros) in random node
order, k=10 smallest, JDQMR_ETol with block 2, basis 24, restart 14, with
the spectrum-verification probe on; first in f32 at tol 1e-5, then on the
same matrix in f64 at tol 1e-10. The format chooser packs the matrix into
the windowed-slot ELL layout and every product goes through the
hand-written kernel of ``primme_tpu_torch/csrc/windowed_ell.cu`` on the
operator's compact warp-sliced layout (no padding slots): its f32 entry
point for the f32 solve, its native FP64 one for the f64 solve.

Phases, each printing its own lines; any failed check raises:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build: compiles both entry points from the checkout's source;
3. f32 layout and kernel: ``pack`` and ``compact`` of the permuted
   matrix timed apart and equal to the operator's arrays; the entry count
   E <= 1.1 nnz and the operator's device bytes <= 1.1 nnz (4 + 4) + 8n.
   The kernel against its plain PyTorch version at k in {1, 2, 4, 8}: max
   |diff| <= 1e-5 * max|y|; the median time of the kernel, the plain
   version and the library call that computes the same product (the
   fastest of ``A_csr @ X``, ``torch.sparse.mm(A_csr, X)`` and
   ``A_csr @ X`` on a column-major copy of X, with ``A_csr`` a
   ``torch.sparse_csr_tensor``: cuSPARSE; the port never calls it),
   each over 21 samples of 10 back-to-back calls between CUDA events,
   queued behind a spin kernel so that host time does not count (the
   kernel also without the spin; the plain version, which reads its
   longest row to the host each call, only without it); and the bound, the bytes the product
   needs (each non-zero's value and column, X and Y, once) over
   3.35 TB/s;
4. f32 solve: the kernel's launch count during the solve, eigenvalues
   within 1e-4 of the closed-form spectrum, every true residual
   (recomputed with the plain version) <= 1.5e-5 * ||A||, probe verified
   and not exhausted, matvec count within 2x of the JAX reference's 1385;
5. f64 layout and kernel: the chooser packs the f64 matrix into an f64
   windowed operator; the layout checks of phase 3 with 8-byte values;
   the FP64 kernel against the f64 plain version at k in {1, 2, 4, 8}:
   max |diff| <= 1e-13 * max|y|, and the times and bound of phase 3;
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
import warnings

GRID = 64            # the problem is the 64^3 grid: n = 262,144
REF_MATVECS = 1385   # the JAX reference's matvecs at GRID (CPU run)
# the JAX reference's matvecs for the f64 solve at GRID, seed 0: its
# eigsh on the f64 matrix (its f64 windowed operator) on the CPU
REF_MATVECS_F64 = 1876
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)


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


_SPIN_CYCLES_PER_MS = None


def spin_cycles_per_ms():
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin, measured on the
    card (the spin counts SM clock cycles, whose rate varies by card and
    clock state); the second of two readings, after the clocks have risen."""
    global _SPIN_CYCLES_PER_MS
    import torch

    if _SPIN_CYCLES_PER_MS is None:
        cycles = 10_000_000
        for _ in range(2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda._sleep(cycles)
            b.record()
            b.synchronize()
            _SPIN_CYCLES_PER_MS = cycles / a.elapsed_time(b)
    return _SPIN_CYCLES_PER_MS


def median_ms(fn, reps=21, per=10, spin=True):
    """Median over ``reps`` samples of the device time of one call. Each
    sample times ``per`` back-to-back calls between two CUDA events. Calls
    run for 0.2 s first, so that the card's clocks have risen. With
    ``spin``, each sample is queued behind a spin kernel
    (``torch.cuda._sleep``) that lasts twice the host time of a warm batch,
    so that the card runs the calls without gaps and neither launch latency
    nor the host's time per call counts; a sample whose queueing took more
    than 0.8 of the spin is late, and a late sample doubles the spin and
    starts the samples over (a fourth late round raises). Without
    ``spin`` the host's pace counts wherever it is slower than the card."""
    import torch

    t0 = time.perf_counter()
    batches = 0
    while True:
        for _ in range(per):
            fn()
        torch.cuda.synchronize()
        batches += 1
        if time.perf_counter() - t0 >= 0.2:
            break
    spin_ms = 2e3 * (time.perf_counter() - t0) / batches
    for _ in range(4):
        times, late = [], 0
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
            q0 = time.perf_counter()
            a.record()
            for _ in range(per):
                fn()
            b.record()
            late += 1e3 * (time.perf_counter() - q0) > 0.8 * spin_ms
            b.synchronize()
            times.append(a.elapsed_time(b) / per)
        if not spin or not late:
            return statistics.median(times)
        spin_ms *= 2
    raise RuntimeError(f"chip_smoke: {late} of {reps} samples queued "
                       "slower than the spin, four times over")


def solve(ptt, A, seed, tol=1e-5):
    return ptt.eigsh(A, k=10, which="SA", tol=tol,
                     method="PRIMME_JDQMR_ETol", maxBlockSize=2, ncv=24,
                     minRestartSize=14, return_stats=True, seed=seed,
                     device="cuda")


def reset_counts(WE):
    WE.LAUNCHES = 0
    for name in WE.KERNEL_LAUNCHES:
        WE.KERNEL_LAUNCHES[name] = 0


def layout_phase(WE, op, Ap, dtype, tag):
    """Rebuild ``op``'s layout from the permuted matrix ``Ap``, timing
    ``pack`` and ``compact`` apart; it must be ``op``'s, hold E <= 1.1 nnz
    entries and take <= 1.1 nnz (sizeof T + 4) + 8n bytes on the card."""
    import numpy as np

    t0 = time.perf_counter()
    p = WE.pack(Ap, dtype=dtype)
    t1 = time.perf_counter()
    lay = WE.compact(p.scal, p.offs, p.vals,
                     (p.nrb, p.S, p.npad, p.n, p.pad, p.WB))
    t2 = time.perf_counter()
    for name in lay._fields:
        check(np.array_equal(getattr(op, name).cpu().numpy(),
                             getattr(lay, name)),
              f"{tag}: the operator's {name} is not compact()'s")
    n, nnz, size = Ap.shape[0], Ap.nnz, np.dtype(dtype).itemsize
    E = len(lay.cols)
    nbytes = sum(b.numel() * b.element_size() for b in op.buffers())
    limit = 1.1 * nnz * (size + 4) + 8 * n
    print(f"[{tag}] pack {t1 - t0:.3f} s  compact {t2 - t1:.3f} s  "
          f"entries E={E} ({E / nnz:.4f} nnz; packed slots "
          f"{p.nrb * p.S * WE.RB})  max row {int(lay.rowlen.max())}  "
          f"operator {nbytes} B on the card (limit {limit:.0f})", flush=True)
    check(E <= 1.1 * nnz, f"{tag}: {E} entries for {nnz} non-zeros")
    check(nbytes <= limit, f"{tag}: operator takes {nbytes} B > {limit:.0f}")
    return {"pack_s": t1 - t0, "compact_s": t2 - t1, "entries": E,
            "entries_per_nnz": E / nnz, "operator_bytes": nbytes}


def csr_on_card(Ap, dtype, dev):
    """``Ap`` as a ``torch.sparse_csr_tensor`` on the card, i32 indices:
    the library call's operand, never the port's."""
    import numpy as np
    import torch

    C = Ap.tocsr()
    with warnings.catch_warnings():     # "beta state", invariant checks
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(C.indptr.astype(np.int32)),
            torch.as_tensor(C.indices.astype(np.int32)),
            torch.as_tensor(C.data.astype(dtype)), size=C.shape).to(dev)


def compare_kernel(WE, op, A_csr, gen, rel, tag):
    """The kernel against its plain version on ``op`` at k in {1,2,4,8}:
    max |diff| <= rel * max|y|; the median time of the kernel (with and
    without the spin), the plain version (without) and the fastest of
    three library calls on ``A_csr``; the bound from the bytes the product
    needs."""
    import numpy as np
    import torch

    n, nnz = op.shape[0], A_csr._nnz()
    size = op.vals.element_size()
    arrays = (op.slice_ptr, op.rowlen, op.cols, op.vals)
    per_k = {}
    for k in (1, 2, 4, 8):
        X = torch.randn((n, k), generator=gen, dtype=op.dtype).to(op.device)
        y = WE.matmat(*arrays, X)
        yref = WE.matmat_reference(*arrays, X)
        Xcm = X.t().contiguous().t()        # the same X, column-major
        libs = {"A_csr @ X": lambda: A_csr @ X,
                "torch.sparse.mm(A_csr, X)": lambda: torch.sparse.mm(A_csr, X),
                "A_csr @ X, X column-major": lambda: A_csr @ Xcm}
        torch.cuda.synchronize()
        err = float((y - yref).abs().max())
        ymax = float(yref.abs().max())
        ms = median_ms(lambda: WE.matmat(*arrays, X))
        nospin_ms = median_ms(lambda: WE.matmat(*arrays, X), spin=False)
        # the plain version reads its longest row to the host once per
        # call: no spin can queue it ahead, and its host pace is its cost
        plain_ms = median_ms(lambda: WE.matmat_reference(*arrays, X),
                             spin=False)
        lib = {}
        for call, f in libs.items():
            lib[call] = {"ms": median_ms(f),
                         "max_abs_err": float((f() - yref).abs().max())}
        library_call = min(lib, key=lambda c: lib[c]["ms"])
        library_ms = lib[library_call]["ms"]
        bound_ms = 1e3 * (nnz * (size + 4) + 2 * n * k * size) \
            / HBM_BYTES_PER_S
        per_k[k] = {"max_abs_err": err, "ymax": ymax, "ms": ms,
                    "nospin_ms": nospin_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "library_call": library_call,
                    "library": lib, "bound_ms": bound_ms,
                    "bound_share": bound_ms / ms}
        print(f"[{tag}] k={k} max|y-yref|={err:.3e} (limit "
              f"{rel * ymax:.3e}) kernel {ms:.4f} ms (without the spin "
              f"{nospin_ms:.4f})  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms (bytes; share {bound_ms / ms:.3f})",
              flush=True)
        print(f"[{tag}] k={k} library: " + "; ".join(
            f"{c} {v['ms']:.4f} ms (max|diff| {v['max_abs_err']:.3e})"
            for c, v in lib.items()) + f" -> library_ms {library_ms:.4f}",
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
    R = WE.matmat_reference(op.slice_ptr, op.rowlen, op.cols, op.vals, Xp) \
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


def kernel_record(name, replaces, launches, per_k, layout):
    k2 = per_k[2]
    return {"name": name, "route": "cuda",
            "source": "primme_tpu_torch/csrc/windowed_ell.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in per_k.values()),
            "ms": k2["ms"], "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"], "bound_by": "bytes",
            "library_ms": k2["library_ms"], "bound_share": k2["bound_share"],
            "library_call": k2["library_call"], "layout": layout,
            "per_k": {str(k): {key: v[key] for key in (
                "ms", "nospin_ms", "plain_ms", "library_ms", "library_call",
                "bound_ms", "bound_share", "max_abs_err")}
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
    print(f"[device] timing spin: {spin_cycles_per_ms():.0f} cycles per ms",
          flush=True)

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

    # --- 3. f32 layout and kernel against its plain version -------------
    A, ev = laplacian27(GRID, args.seed)
    n = A.shape[0]
    t0 = time.perf_counter()
    op, perm = ptt.rcm_banded(A)
    check(isinstance(op, ptt.WindowedELLOperator),
          f"format chooser picked {type(op).__name__}")
    op = op.to(dev)
    print(f"[kernel] n={n} nnz={A.nnz} meta(nrb,S,npad,n,pad,WB)={op.meta} "
          f"chooser {time.perf_counter() - t0:.2f} s", flush=True)
    Ap = A[perm][:, perm]
    layout32 = layout_phase(WE, op, Ap, np.float32, "kernel")
    gen = torch.Generator().manual_seed(args.seed)
    per_k = compare_kernel(WE, op, csr_on_card(Ap, np.float32, dev), gen,
                           1e-5, "kernel")

    # --- 4. f32 solve -------------------------------------------------------
    solve32 = run_solve(ptt, WE, A, op, perm, ev, args.seed, tol=1e-5,
                        ev_tol=1e-4, ref_mv=REF_MATVECS,
                        entry="windowed_ell_spmm_f32", tag="solve")

    # --- 5. f64 layout and kernel against its plain version -------------
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
    Ap64 = A64[perm64][:, perm64]
    layout64 = layout_phase(WE, op64, Ap64, np.float64, "kernel64")
    per_k64 = compare_kernel(WE, op64, csr_on_card(Ap64, np.float64, dev),
                             gen, 1e-13, "kernel64")

    # --- 6. f64 solve -------------------------------------------------------
    solve64 = run_solve(ptt, WE, A64, op64, perm64, ev, args.seed,
                        tol=1e-10, ev_tol=1e-8, ref_mv=REF_MATVECS_F64,
                        entry="windowed_ell_spmm_f64", tag="solve64")

    rec = {"kernels": [
        kernel_record("windowed_ell_spmm_f32",
                      "primme_tpu/ops/pallas_windowed.py:228",
                      solve32["launches"], per_k, layout32),
        kernel_record("windowed_ell_spmm_f64",
                      "primme_tpu/ops/pallas_windowed.py:363",
                      solve64["launches"], per_k64, layout64)],
        "solve": {**solve32, "f64": solve64},
        "spin_cycles_per_ms": spin_cycles_per_ms()}
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
