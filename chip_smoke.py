#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``primme_tpu_torch``) on one card.

Drives the port's paths once at full size. The sparse paths: ``eigsh`` on
the 64^3 27-point Laplacian (n = 262,144, 6.86M nonzeros) in random node
order, k=10 smallest, JDQMR_ETol with block 2, basis 24, restart 14, with
the spectrum-verification probe on; first in f32 at tol 1e-5, then on the
same matrix in f64 at tol 1e-10. The format chooser packs the matrix into
the windowed-slot ELL layout and every product goes through the
hand-written kernel of ``primme_tpu_torch/csrc/windowed_ell.cu`` on the
operator's compact warp-sliced layout (no padding slots): its f32 entry
point for the f32 solve, its native FP64 one for the f64 solve. Then
``bench.py``'s headline: the 7-point Laplacian ``Stencil3DOperator`` on
the 64^3 grid with the shift-aware ``JacobiPrecond``, the same settings in
f32 at tol 1e-5, through ``solve_eigs``; every product runs
``csrc/stencil3d.cu`` and every preconditioner apply ``csrc/jacobi.cu``.
Last, ``__graft_entry__.entry``'s GD_Olsen_plusK + Jacobi on the 16^3
stencil, run to convergence.

Phases, each printing its own lines; any failed check raises:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build: compiles ``windowed_ell.cu``, ``stencil3d.cu`` and ``jacobi.cu``
   from the checkout's sources, one ``nvcc`` each, all started together;
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
   exhausted, matvec count within 2x of the JAX reference's 1876;
7. stencil kernel against its plain version, f32 and f64, at every shape
   of ``KERNEL_SHAPES``: the 64^3 grid at k in {1, 2, 4, 8}, 128^3 and
   256^3 at k in {2, 8}, and at 64^3 a k=2 column slice of a [n, 24]
   block at column offset 1 (rows 24 apart, 4 bytes off 8: the kernel's
   scalar path, as the solve's basis slices may be): bit for bit (NaN for
   NaN); the launch plan (columns a point, load width, the stencil's
   tile and grid); the kernel's time with the spin and without, the plain
   version's, the bound (X read and Y written once over 3.35 TB/s) and
   the share; ``library_ms``, a depthwise ``conv3d`` over the same memory
   (cuDNN, TF32 off; timed only, its max |diff| printed); ``copy_ms``,
   torch's copy of X into a preallocated Y (the same bytes in one launch:
   the launch-and-bytes floor; a yardstick the port never calls);
8. Jacobi kernel against its plain version at the same shapes and types,
   the shifted entry (one shift equal to a diagonal entry, so the eps
   clamp fires) and the unshifted one: bit for bit; the times of phase 7
   with ``copy_ms``; no library call (``library_ms`` null: no single
   PyTorch call computes ``X / guard(d - sigma)``, the eps guard is part of
   the function);
9. the headline: ``bench.py``'s configuration through ``solve_eigs``, one
   untimed solve and then the minimum of 3 timed ones, each printed;
   ``bench.py``'s ``ok`` (max resnorm <= 1.5e-5 * anorm_estimate,
   eigenvalues within 1e-4 of the closed form), every true residual (the
   stencil's plain version) <= 1.5e-5 * ||A||, probe verified and not
   exhausted, matvecs within 2x of the JAX reference's 1710, stencil
   launches >= matvecs / 2, Jacobi launches > 0, no windowed-ELL launch;
   the share of each kernel's launches that took the vector path; the
   peak device memory and the share of the solve time the two kernels
   account for (launches x their k=2 time);
10. GD_Olsen_plusK + Jacobi on the 16^3 stencil, k=4, tol 1e-4:
    eigenvalues within 1e-4 of the closed form, probe verified, matvecs
    within 2x of the JAX reference's 494, Jacobi launches > 0 (the Olsen
    correction of ``gd_correction``).

Each solve also prints its peak device memory. The second-to-last line is
a JSON record of the kernels and the solves; the last is
``{"ok": true, "device": {...}}``. Run: ``python3 chip_smoke.py``.
"""

import argparse
import concurrent.futures
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
L2_BYTES = 50e6             # H100 SXM L2 (the same data sheet)
# the JAX reference's counts for bench.py's configuration (64^3 stencil +
# Jacobi, JDQMR_ETol; solve_eigs on the CPU, x64 off as bench.py runs)
REF_HEADLINE_MATVECS = 1710
REF_HEADLINE_PROBE = (440, 3)        # num_probe_matvecs, num_probe_rounds
GD_GRID = 16
REF_GD_MATVECS = 494   # the JAX reference, GD_Olsen_plusK + Jacobi at 16^3
KERNEL_SOURCES = ("windowed_ell", "stencil3d", "jacobi")
# phases 7-8: (grid side, k, column offset in a SLICE_WIDTH-wide block or
# None for a contiguous [n, k] block)
KERNEL_SHAPES = ([(GRID, k, None) for k in (1, 2, 4, 8)]
                 + [(side, k, None) for side in (128, 256) for k in (2, 8)]
                 + [(GRID, 2, 1)])
SLICE_WIDTH = 24
HEADLINE_SHAPE = f"{GRID}^3 k=2"    # the shape the record's top level reads


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


def reset_counts(*mods):
    for mod in mods:
        mod.LAUNCHES = 0
        for counts in (mod.KERNEL_LAUNCHES,
                       getattr(mod, "VECTOR_LAUNCHES", {})):
            for name in counts:
                counts[name] = 0


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

    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST

    dev = op.device
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(WE, ST, JK)
    t0 = time.perf_counter()
    w, V, st = solve(ptt, A, seed, tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**WE.KERNEL_LAUNCHES, **ST.KERNEL_LAUNCHES,
                **JK.KERNEL_LAUNCHES}
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
    print(f"[{tag}] kernel launches {WE.KERNEL_LAUNCHES}  max|eval-analytic| "
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


def stencil_eigenvalues(m, k):
    """The k smallest eigenvalues of the 7-point Dirichlet Laplacian on an
    m^3 grid in closed form (``bench.py``'s), and its norm (the largest)."""
    import numpy as np

    ax = 2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    lam = np.sort((ax[:, None, None] + ax[None, :, None]
                   + ax[None, None, :]).ravel())
    return lam[:k], float(3 * ax.max())


def _bitwise(a, b):
    """a and b equal element for element, NaN for NaN."""
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _times(kernel, plain, nbytes, copy, library=None):
    """The kernel's median time with and without the spin, the plain
    version's (with the spin: it reads nothing back to the host), torch's
    copy of the same bytes and the library call's, beside the bound: the
    ``nbytes`` the function moves over the device memory's rate. Where they
    fit in L2, the repeated calls of ``median_ms`` find them there, so the
    share is not one of a device-memory bound (``l2_resident``)."""
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    out = {"ms": median_ms(kernel), "nospin_ms": median_ms(kernel, spin=False),
           "plain_ms": median_ms(plain), "copy_ms": median_ms(copy),
           "bound_ms": bound_ms, "l2_resident": nbytes <= L2_BYTES,
           "library_ms": median_ms(library) if library is not None else None}
    out["bound_share"] = bound_ms / out["ms"]
    return out


def _print_times(tag, shape, err, bit, t, plan, extra=""):
    print(f"[{tag}] {shape} max|y-yref|={err:.3e} bit for bit {bit}; plan "
          f"kc={plan.kc} vw={plan.vw} ({'vector' if plan.vw > 1 else 'scalar'}"
          f" path)" + (f" tile {plan.tl}x{plan.tj}, grid {plan.grid}"
                       if hasattr(plan, "grid") else f" blocks {plan.blocks}")
          + f"; kernel {t['ms']:.5f} ms (without the "
          f"spin {t['nospin_ms']:.5f})  plain {t['plain_ms']:.5f} ms  copy "
          f"{t['copy_ms']:.5f} ms  bound {t['bound_ms']:.5f} ms (bytes; share "
          f"{t['bound_share']:.3f}"
          + (", L2-resident" if t["l2_resident"] else "") + ")" + extra,
          flush=True)


def shape_label(side, k, off):
    return f"{side}^3 k={k}" + (f" slice+{off} of {SLICE_WIDTH}"
                                if off is not None else "")


def kernel_block(side, k, off, dtype, dev, gen):
    """A random [side^3, k] block on the card: contiguous, or columns
    [off, off + k) of a SLICE_WIDTH-wide one."""
    import torch

    n = side ** 3
    if off is None:
        return torch.randn((n, k), generator=gen, dtype=dtype, device=dev)
    W = torch.randn((n, SLICE_WIDTH), generator=gen, dtype=dtype, device=dev)
    return W[:, off:off + k]


def stencil_phase(ST, dev, gen, scale=1.0):
    """The stencil kernel against its plain version at every shape of
    ``KERNEL_SHAPES``, f32 and f64, bit for bit; timed beside its bound,
    torch's copy of X and a depthwise ``conv3d`` over the same memory
    (``library_ms``; cuDNN with TF32 off, as the package sets it)."""
    import torch
    import torch.nn.functional as F

    check(not torch.backends.cudnn.allow_tf32,
          "cuDNN would run the conv3d yardstick in TF32")
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = "stencil3d_f32" if dtype == torch.float32 else "stencil3d_f64"
        size = torch.finfo(dtype).bits // 8
        w = torch.zeros((3, 3, 3), dtype=dtype)
        w[1, 1, 1] = 6.0
        for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                  (1, 1, 2)):
            w[c] = -1.0
        per_shape = {}
        for side, k, off in KERNEL_SHAPES:
            n, label = side ** 3, shape_label(side, k, off)
            X = kernel_block(side, k, off, dtype, dev, gen)
            grid = (side, side, side)
            y = ST.matmat(X, *grid, scale)
            yref = ST.matmat_reference(X, *grid, scale)
            # the same memory as a (1, k, nx, ny, nz) channels-last-3d input
            Xc = X.view(1, side, side, side, k).permute(0, 4, 1, 2, 3)
            wk = (scale * w).expand(k, 1, 3, 3, 3).contiguous().to(dev)

            def conv():
                return F.conv3d(Xc, wk, padding=1, groups=k)

            ylib = conv().permute(0, 2, 3, 4, 1).reshape(n, k)
            Yc = torch.empty((n, k), dtype=dtype, device=dev)
            torch.cuda.synchronize()
            err = float((y - yref).abs().max())
            bit = _bitwise(y, yref)
            lib_err = float((ylib - yref).abs().max())
            plan = ST.card_plan(X, *grid)
            t = _times(lambda: ST.matmat(X, *grid, scale),
                       lambda: ST.matmat_reference(X, *grid, scale),
                       2 * n * k * size, lambda: Yc.copy_(X), conv)
            per_shape[label] = {"max_abs_err": err, "bitwise": bit,
                                "vector_path": plan.vw > 1,
                                "plan": plan._asdict(),
                                "library_call": "conv3d depthwise (cuDNN)",
                                "library_max_abs_err": lib_err, **t}
            _print_times(name, label, err, bit, t, plan,
                         f"  library (depthwise conv3d) {t['library_ms']:.5f}"
                         f" ms (max|diff| {lib_err:.3e})")
            check(bit, f"{name}: kernel differs from its plain version at "
                  f"{label}")
            del X, y, yref, ylib, Xc, Yc
        out[name] = per_shape
    return out


def jacobi_phase(JK, dev, gen):
    """Both Jacobi entry points against their plain versions at every shape
    of ``KERNEL_SHAPES``, f32 and f64, bit for bit: ``d`` spans [1, 11],
    the first shift equals ``d`` of the middle row (the eps clamp fires
    there), the others lie in [0, 1] (the smallest Ritz values of the
    headline)."""
    import torch

    out = {}
    for dtype in (torch.float32, torch.float64):
        suffix = "f32" if dtype == torch.float32 else "f64"
        size = torch.finfo(dtype).bits // 8
        res = {"jacobi_shifted_" + suffix: {}, "jacobi_" + suffix: {}}
        for side, k, off in KERNEL_SHAPES:
            n, label = side ** 3, shape_label(side, k, off)
            d = 1.0 + 10.0 * torch.rand(n, generator=gen, dtype=dtype,
                                        device=dev)
            X = kernel_block(side, k, off, dtype, dev, gen)
            s = torch.rand(k, generator=gen, dtype=dtype, device=dev)
            s[0] = d[n // 2]
            eps = 1e-10
            Yc = torch.empty((n, k), dtype=dtype, device=dev)
            pairs = (
                ("jacobi_shifted_" + suffix,
                 lambda: JK.shifted(X, d, s, eps),
                 lambda: JK.shifted_reference(X, d, s, eps), k),
                ("jacobi_" + suffix, lambda: JK.unshifted(X, d, eps),
                 lambda: JK.unshifted_reference(X, d, eps), 0))
            for name, kern, plain, nsig in pairs:
                y, yref = kern(), plain()
                torch.cuda.synchronize()
                err = float((y - yref).abs().max())
                bit = _bitwise(y, yref)
                plan = JK.card_plan(X)
                t = _times(kern, plain, (2 * n * k + n + nsig) * size,
                           lambda: Yc.copy_(X))
                res[name][label] = {"max_abs_err": err, "bitwise": bit,
                                    "vector_path": plan.vw > 1,
                                    "plan": plan._asdict(), **t}
                _print_times(name, label, err, bit, t, plan)
                check(bit, f"{name}: kernel differs from its plain version "
                      f"at {label}")
                check(bool(torch.isfinite(y).all()),
                      f"{name}: non-finite output at {label}")
            del X, d, y, yref, Yc
        out.update(res)
    return out


def headline_phase(ptt, dev, grid=GRID, ref_mv=REF_HEADLINE_MATVECS,
                   timed=3):
    """``bench.py``'s solve through the port's ``solve_eigs``: one untimed
    solve, then ``timed`` timed ones (each ends in a device sync); every
    solve gated. Returns the record and the launches of the first timed
    solve."""
    import numpy as np
    import torch
    from primme_tpu_torch.core.inner import jdqmr_inner_solve
    from primme_tpu_torch.core.solver import solve_eigs
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    n = grid ** 3
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    K = ptt.JacobiPrecond(A.diagonal())
    p = ptt.PrimmeParams(n=n, num_evals=10, eps=1e-5, max_basis_size=24,
                         max_block_size=2, min_restart_size=14,
                         max_matvecs=16000, locking=0)
    p = ptt.set_method(ptt.Method.JDQMR_ETol, p, has_precond=True)
    v0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 2)),
                         dtype=torch.float32).to(dev)
    lam, anorm = stencil_eigenvalues(grid, 10)
    runs = []
    for i in range(1 + timed):
        tag = "headline" + (" untimed" if i == 0 else f" timed {i}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            before_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(WE, ST, JK)
        t0 = time.perf_counter()
        res = solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32,
                         inner_solve=jdqmr_inner_solve)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**ST.KERNEL_LAUNCHES, **JK.KERNEL_LAUNCHES,
                    **WE.KERNEL_LAUNCHES}
        vector = {**ST.VECTOR_LAUNCHES, **JK.VECTOR_LAUNCHES}
        st = res.stats
        evals = res.evals.cpu().numpy()
        err = float(np.abs(np.sort(evals) - lam).max())
        max_res = float(res.resnorms.max())
        ok = max_res <= 1.5e-5 * st.anorm_estimate and err <= 1e-4
        X = res.evecs.to(torch.float64)
        R = (ST.matmat_reference(X, grid, grid, grid)
             - X * res.evals.to(torch.float64)[None, :])
        true_res = float(torch.linalg.vector_norm(R, dim=0).max())
        run = {"wall_s": wall, "num_matvecs": st.num_matvecs,
               "num_probe_matvecs": st.num_probe_matvecs,
               "num_probe_rounds": st.num_probe_rounds,
               "num_preconds": st.num_preconds,
               "num_outer_iterations": st.num_outer_iterations,
               "num_inner_iterations": st.num_inner_iterations,
               "eval_err": err, "max_resnorm": max_res,
               "resnorm_tol": 1.5e-5 * st.anorm_estimate,
               "anorm_estimate": st.anorm_estimate,
               "max_true_residual": true_res, "ok": ok,
               "probe_verified": st.probe_verified,
               "probe_exhausted": st.probe_exhausted,
               "launches": launches, "vector_launches": vector}
        if dev.type == "cuda":
            run["peak_bytes"] = torch.cuda.max_memory_allocated()
            run["bytes_before"] = before_bytes
        runs.append(run)
        print(f"[{tag}] solve {wall:.4f} s  num_matvecs {st.num_matvecs} "
              f"(reference {ref_mv})  num_probe_matvecs "
              f"{st.num_probe_matvecs}  num_probe_rounds "
              f"{st.num_probe_rounds} (reference {REF_HEADLINE_PROBE})  "
              f"outer {st.num_outer_iterations}  inner "
              f"{st.num_inner_iterations}  preconds {st.num_preconds}",
              flush=True)
        print(f"[{tag}] ok {ok}: max resnorm {max_res:.3e} (limit "
              f"{1.5e-5 * st.anorm_estimate:.3e}, anorm_estimate "
              f"{st.anorm_estimate:.4f})  max|eval-analytic| {err:.3e}  "
              f"max true residual {true_res:.3e} (limit "
              f"{1.5e-5 * anorm:.3e})  probe verified {st.probe_verified} "
              f"exhausted {st.probe_exhausted}  launches {launches}"
              + (f"  peak device memory {run['peak_bytes']} B "
                 f"({before_bytes} B before)" if dev.type == "cuda" else ""),
              flush=True)
        print(f"[{tag}] vector-path launches: " + "; ".join(
            f"{e} {vector[e]} of {launches[e]} "
            f"({vector[e] / max(launches[e], 1):.3f})"
            for e in ("stencil3d_f32", "jacobi_shifted_f32")), flush=True)
        mv = st.num_matvecs
        check(ok, f"{tag}: bench.py's correctness gate failed")
        check(true_res <= 1.5e-5 * anorm,
              f"{tag}: true residual {true_res:.3e} > 1.5e-5*||A||")
        check(st.probe_verified == 1 and st.probe_exhausted == 0,
              f"{tag}: spectrum verification did not complete")
        check(ref_mv / 2 <= mv <= 2 * ref_mv,
              f"{tag}: {mv} matvecs, not within 2x of the reference's "
              f"{ref_mv}")
        if dev.type == "cuda":
            check(launches["stencil3d_f32"] >= mv / 2,
                  f"{tag}: only {launches['stencil3d_f32']} stencil launches "
                  f"for {mv} matvecs")
            check(launches["jacobi_shifted_f32"] > 0,
                  f"{tag}: no shifted Jacobi launch")
            check(not any(WE.KERNEL_LAUNCHES.values()),
                  f"{tag}: a windowed-ELL kernel served the stencil")
    timed_walls = [r["wall_s"] for r in runs[1:]]
    print(f"[headline] timed solves {timed_walls} s: min "
          f"{min(timed_walls):.4f} s", flush=True)
    return {"solves": runs, "timed_s": timed_walls,
            "wall_s": min(timed_walls), "n": n}, runs[1]


def gdk_phase(ptt, dev, grid=GD_GRID, ref_mv=REF_GD_MATVECS):
    """``__graft_entry__.entry``'s method, GD_Olsen_plusK with Jacobi on the
    ``grid``^3 stencil (k=4, tol 1e-4), run to convergence."""
    import numpy as np
    import torch
    from primme_tpu_torch.core.solver import solve_eigs
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    n = grid ** 3
    A = ptt.Stencil3DOperator(grid, grid, grid, dtype=torch.float32,
                              device=dev)
    K = ptt.JacobiPrecond(A.diagonal())
    p = ptt.set_method(ptt.Method.GD_Olsen_plusK,
                       ptt.PrimmeParams(n=n, num_evals=4, eps=1e-4),
                       has_precond=True)
    v0 = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 1)),
                         dtype=torch.float32).to(dev)
    reset_counts(WE, ST, JK)
    t0 = time.perf_counter()
    res = solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ST.KERNEL_LAUNCHES, **JK.KERNEL_LAUNCHES}
    st = res.stats
    lam, _ = stencil_eigenvalues(grid, 4)
    err = float(np.abs(np.sort(res.evals.cpu().numpy()) - lam).max())
    mv = st.num_matvecs
    print(f"[gdk] GD_Olsen_plusK + Jacobi {grid}^3: solve {wall:.4f} s  "
          f"num_matvecs {mv} (reference {ref_mv})  num_probe_matvecs "
          f"{st.num_probe_matvecs}  num_probe_rounds {st.num_probe_rounds}  "
          f"preconds {st.num_preconds}  max|eval-analytic| {err:.3e}  probe "
          f"verified {st.probe_verified}  launches {launches}", flush=True)
    check(err <= 1e-4, f"gdk: eigenvalue error {err:.3e} > 1e-4")
    check(st.probe_verified == 1 and st.probe_exhausted == 0,
          "gdk: spectrum verification did not complete")
    check(ref_mv / 2 <= mv <= 2 * ref_mv,
          f"gdk: {mv} matvecs, not within 2x of the reference's {ref_mv}")
    if dev.type == "cuda":
        check(launches["stencil3d_f32"] >= mv / 2 and
              launches["jacobi_shifted_f32"] > 0,
              f"gdk: the kernels did not serve the solve: {launches}")
    return {"wall_s": wall, "num_matvecs": mv, "eval_err": err,
            "num_probe_matvecs": st.num_probe_matvecs,
            "num_probe_rounds": st.num_probe_rounds,
            "num_preconds": st.num_preconds, "launches": launches}


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


def main_path_record(name, source, replaces, run, per_entry, others):
    """The record of a kernel of the headline's path (its f32 entry point,
    at ``HEADLINE_SHAPE``) with its other entry points' numbers under
    ``entries``; ``run`` is the headline solve whose counts (every entry
    point's launches, and those that took the vector path) it reads."""
    keys = ("ms", "nospin_ms", "plain_ms", "copy_ms", "library_ms",
            "bound_ms", "bound_share", "max_abs_err", "bitwise",
            "vector_path", "plan")

    def by_shape(per_shape):
        return {label: {key: v[key] for key in keys}
                for label, v in per_shape.items()}

    top = per_entry[name][HEADLINE_SHAPE]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["launches"][name],
            "vector_launches": run["vector_launches"][name],
            "max_abs_err": max(v["max_abs_err"]
                               for v in per_entry[name].values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes",
            "library_ms": top["library_ms"], "copy_ms": top["copy_ms"],
            "bound_share": top["bound_share"],
            "library_call": top.get("library_call"),
            "shapes": by_shape(per_entry[name]),
            "entries": {other: {"replaces": rep,
                                "launches": run["launches"][other],
                                "vector_launches":
                                    run["vector_launches"][other],
                                "shapes": by_shape(per_entry[other])}
                        for other, rep in others.items()}}


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
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
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
    # always from the checkout's sources: one nvcc per source, all at once
    for src in KERNEL_SOURCES:
        if os.path.exists(build.library_path(src)):
            os.remove(build.library_path(src))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        handles = dict(zip(KERNEL_SOURCES, pool.map(build.load,
                                                    KERNEL_SOURCES)))
    for src, mod in (("windowed_ell", WE), ("stencil3d", ST),
                     ("jacobi", JK)):
        entries = list(mod.KERNEL_LAUNCHES)
        for entry in entries:
            getattr(handles[src], entry)  # AttributeError if it is missing
        print(f"[build] {src}.cu -> "
              f"{os.path.relpath(build.library_path(src))}; entry points "
              f"{entries}", flush=True)
    print(f"[build] {len(KERNEL_SOURCES)} sources in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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

    # --- 7. stencil kernel against its plain version --------------------
    # inputs made on the card (256^3 at k=8 in f64 is 1 GB a block)
    cgen = torch.Generator(device=dev).manual_seed(args.seed)
    sten = stencil_phase(ST, dev, cgen)

    # --- 8. Jacobi kernels against their plain versions -------------------
    jac = jacobi_phase(JK, dev, cgen)

    # --- 9. the headline: bench.py's configuration ----------------------
    headline, hl_run = headline_phase(ptt, dev)
    hl_launches = hl_run["launches"]
    first = headline["solves"][1]["wall_s"]       # the first timed solve
    kernel_ms = {entry: hl_launches[entry] * per[HEADLINE_SHAPE]["ms"]
                 for entry, per in
                 (("stencil3d_f32", sten["stencil3d_f32"]),
                  ("jacobi_shifted_f32", jac["jacobi_shifted_f32"]))}
    headline["kernel_share"] = {entry: ms / (1e3 * first)
                                for entry, ms in kernel_ms.items()}
    print(f"[headline] first timed solve {first:.4f} s; launches x "
          f"{HEADLINE_SHAPE} time: " + "; ".join(
              f"{entry} {hl_launches[entry]} x -> {ms:.2f} ms "
              f"({headline['kernel_share'][entry]:.4f} of the solve)"
              for entry, ms in kernel_ms.items()), flush=True)

    # --- 10. GD_Olsen_plusK + Jacobi (__graft_entry__.entry's method) ----
    gdk = gdk_phase(ptt, dev)

    rec = {"kernels": [
        kernel_record("windowed_ell_spmm_f32",
                      "primme_tpu/ops/pallas_windowed.py:228",
                      solve32["launches"], per_k, layout32),
        kernel_record("windowed_ell_spmm_f64",
                      "primme_tpu/ops/pallas_windowed.py:363",
                      solve64["launches"], per_k64, layout64),
        main_path_record("stencil3d_f32", "primme_tpu_torch/csrc/stencil3d.cu",
                         "primme_tpu/operators.py:379", hl_run, sten,
                         {"stencil3d_f64": "primme_tpu/operators.py:379"}),
        main_path_record("jacobi_shifted_f32",
                         "primme_tpu_torch/csrc/jacobi.cu",
                         "primme_tpu/operators.py:484", hl_run, jac,
                         {"jacobi_shifted_f64": "primme_tpu/operators.py:484",
                          "jacobi_f32": "primme_tpu/operators.py:481",
                          "jacobi_f64": "primme_tpu/operators.py:481"})],
        "solve": {**solve32, "f64": solve64},
        "headline": headline, "gdk": gdk,
        "spin_cycles_per_ms": spin_cycles_per_ms()}
    print(json.dumps(rec))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
