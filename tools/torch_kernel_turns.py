#!/usr/bin/env python3
"""The stencil, Jacobi, DIA and sliced-ELL kernels of this checkout against
those of another checkout (say the parent commit, unpacked with ``git
archive`` into the git-ignored ``_work/parent``), in turns on one card.

The cases, each wrapper on its default path:

* the stencil and both Jacobi entry points in f32 and f64 at every shape
  of ``chip_smoke.KERNEL_SHAPES`` (64^3 at k in {1, 2, 4, 8}, 128^3 and
  256^3 at k in {2, 8}, a k=2 column slice at offset 1 of a 24-wide
  block);
* the four complex Jacobi entry points at
  ``chip_smoke.JACOBI_COMPLEX_SHAPES`` (complex denominators, the first
  shift on a diagonal entry, as phase 38 has them);
* the sliced-ELL kernel at k in {1, 2, 4, 8} on the complex scatter
  (complex64, phase 26), the magnetic incidence's ``A`` and ``A^H``
  (complex128, phase 27), the grounded incidence's ``A`` in f32 and f64
  (phase 19) and the permuted 27-point Laplacian in f32 and f64 (phases 3
  and 5);
* the f16 and bf16 stencil at 64^3 and 256^3, k = 1 and 2, and at 64^3
  the k = 1 and 2 column slices at offset 1 of a 24-wide block (the
  scalar paths);
* on the 27-point Laplacian's 27 diagonals (``chip_smoke.laplacian27_dia``,
  built on the card): the f16 and bf16 DIA entry points and the mixed
  ones with an f32 and an f64 block (``dia_f16_f32``, ``dia_bf16_f64``,
  ...) at 64^3 and 256^3, k = 1, 2 and 4, and at 64^3 the k = 2 slice at
  offset 1 (half block: matmat timed, rmatmat held bit for bit too;
  mixed: both timed); the f32, f64, complex64 and complex128 ones at
  64^3 and 256^3, k = 2 (matmat timed, rmatmat held bit for bit too);
  the half rows with their bytes bound (``bound_ms``: vals, X and Y once,
  at ``chip_smoke.HBM_BYTES_PER_S``), the half k = 1 and the mixed k = 2
  rows with ``copy_ms`` and cuSPARSE's CSR product in the block's type
  (``library_ms``, this checkout's call only);
* this checkout's two half DIA kernels on one column (k = 1) at 64^3 and
  256^3: the run kernel the plan picks against the rows-32-apart kernel,
  the measurement behind that choice;
* the Jacobi entry points over a half diagonal with a half, f32 and f64
  block, shifted and unshifted, at 64^3 and 256^3, k = 1, 2 and 4, with
  their bytes bound, and at k = 2 ``copy_ms`` and ``library_ms``.

The two versions' outputs on the same input must agree bit for bit (NaN
for NaN); then each is timed with ``chip_smoke.median_ms`` (behind the
spin) in the order old, new, new, old, so that a drift of the card's
clocks falls on both. The other checkout's ``primme_tpu_torch/ops`` is
imported under another name and builds its own sources into its own
``_build/``. Prints one line per case and the card's name and power
limit; with ``--json PATH``, writes every number there.

With ``--groups``, the stencil of this checkout is also timed, at every
shape, under the plan of each column group a point may hold (``kc`` of 1,
2, 4, 8 dividing k; ``ops/stencil3d.py::plan``'s ``kc``), each checked bit
for bit against the wrapper's output: the measurement behind the plan's
rule (the largest group that divides k). Rerun it before changing that
rule.

With ``--half-only``, only the half stencil, DIA and Jacobi rows run.

Run: ``python3 tools/torch_kernel_turns.py --parent _work/parent
[--groups] [--half-only] [--json PATH]``.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_ops(checkout, name):
    """``primme_tpu_torch/ops`` of ``checkout`` as the package ``name``;
    returns its stencil3d, jacobi, windowed_ell and dia modules."""
    pkg = os.path.join(os.path.abspath(checkout), "primme_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.{mod}")
                 for mod in ("stencil3d", "jacobi", "windowed_ell", "dia"))


def turns(old, new, median_ms):
    """Median times of old, new, new, old; the means of each pair."""
    t = [median_ms(old), median_ms(new), median_ms(new), median_ms(old)]
    return {"turns_ms": t, "old_ms": (t[0] + t[3]) / 2,
            "new_ms": (t[1] + t[2]) / 2, "old_spread_ms": abs(t[0] - t[3]),
            "new_spread_ms": abs(t[1] - t[2])}


def compare(entry, label, new_call, old_call, median_ms, bitwise, check,
            **info):
    """One case: bit for bit, then timed in turns; its row, printed."""
    same = bitwise(new_call(), old_call())
    check(same, f"{entry} at {label}: the two checkouts' kernels differ")
    row = {"entry": entry, "shape": label, **info, "bitwise": same,
           **turns(old_call, new_call, median_ms)}
    print(f"[turns] {entry} {label} "
          + " ".join(f"{k}={v}" for k, v in info.items()) + ": old "
          + " ".join(f"{t:.5f}" for t in row["turns_ms"][::3])
          + " ms, new " + " ".join(f"{t:.5f}" for t in row["turns_ms"][1:3])
          + f" ms -> {row['old_ms']:.5f} / {row['new_ms']:.5f}"
          f" = {row['old_ms'] / row['new_ms']:.3f}x", flush=True)
    return row


def complex_jacobi(CS, JK, OJK, dev, gen):
    """The complex Jacobi entry points of both checkouts at
    ``JACOBI_COMPLEX_SHAPES``."""
    import torch

    def bitwise(a, b):
        return CS._bitwise(torch.view_as_real(a), torch.view_as_real(b))

    rows = []
    for suffix, tname in CS.JACOBI_COMPLEX:
        dtype = getattr(torch, tname)
        rdt = torch.float32 if suffix == "c64" else torch.float64
        for side, k, off in CS.JACOBI_COMPLEX_SHAPES:
            n, label = side ** 3, CS.shape_label(side, k, off)
            X = CS.kernel_block(side, k, off, dtype, dev, gen)
            d = torch.complex(
                1.0 + 10.0 * torch.rand(n, generator=gen, dtype=rdt,
                                        device=dev),
                torch.randn(n, generator=gen, dtype=rdt, device=dev))
            s = torch.complex(
                torch.rand(k, generator=gen, dtype=rdt, device=dev),
                torch.randn(k, generator=gen, dtype=rdt, device=dev))
            s[0] = d[n // 2]
            p = JK.card_plan(X)
            for entry, call in (
                    ("jacobi_shifted_" + suffix,
                     lambda m: m.shifted(X, d, s, 1e-10)),
                    ("jacobi_" + suffix, lambda m: m.unshifted(X, d, 1e-10))):
                rows.append(compare(
                    entry, label, lambda: call(JK), lambda: call(OJK),
                    CS.median_ms, bitwise, CS.check,
                    plan=f"kc{p.kc}/vw{p.vw}/cols{p.cols}"))
            del X, d
    return rows


def ell_layouts(CS, seed):
    """``(name, arrays, ncols)`` of the sliced-ELL layouts timed here."""
    import numpy as np
    import primme_tpu_torch as ptt
    from primme_tpu_torch.ops import windowed_ell as WE

    C = CS.complex_scattered_matrix(CS.GRID ** 3, seed)
    yield "complex scatter", WE.from_csr(C, np.complex64), C.shape[1]
    G = CS.magnetic_svd_matrix(CS.MAG_GRID)[0]
    yield "magnetic incidence A", WE.from_csr(G, np.complex128), G.shape[1]
    GH = G.conj().T.tocsr()
    yield "magnetic incidence A^H", WE.from_csr(GH, np.complex128), \
        GH.shape[1]
    for dt in ("float32", "float64"):
        M = CS.grounded_incidence(CS.SVD_GRID, dtype=dt)[0]
        yield f"svds A {dt}", WE.from_csr(M, dt), M.shape[1]
    A, _ = CS.laplacian27(CS.GRID, seed)
    for dt in (np.float32, np.float64):
        op, _ = ptt.rcm_banded(A.astype(dt))
        yield (f"27-point {np.dtype(dt).name}",
               [getattr(op, f) for f in WE.SlicedELL._fields], A.shape[1])


def sliced_ell(CS, WE, OWE, dev, gen, seed):
    """The sliced-ELL kernel of both checkouts on ``ell_layouts``, at k in
    {1, 2, 4, 8}; this checkout's wrapper on the path its rule picks."""
    import torch

    def bitwise(a, b):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        return CS._bitwise(a, b)

    rows = []
    for name, lay, ncols in ell_layouts(CS, seed):
        arrays = [torch.as_tensor(a).to(dev) for a in lay]
        path = WE.choose_path(arrays[0], arrays[2])
        for k in (1, 2, 4, 8):
            X = torch.randn((ncols, k), generator=gen, dtype=arrays[3].dtype,
                            device=dev)
            rows.append(compare(
                "windowed_ell_spmm", f"{name} k={k}",
                lambda: WE.matmat(*arrays, X, ncols),
                lambda: OWE.matmat(*arrays, X, ncols), CS.median_ms, bitwise,
                CS.check, path=path,
                mean_width=round(WE.mean_width(arrays[0], arrays[2]), 3)))
        del arrays
    return rows


HALF_STENCIL_SHAPES = [(64, 1, None), (64, 2, None), (64, 1, 1), (64, 2, 1),
                       (256, 1, None), (256, 2, None)]
HALF_DIA_SHAPES = [(64, 1, None), (64, 2, None), (64, 4, None), (64, 2, 1),
                   (256, 1, None), (256, 2, None), (256, 4, None)]
HALF_JACOBI_K = (1, 2, 4)
EXTRA_K = 2          # the k of the rows that also time copy_ms, library_ms


def half_block(CS, side, k, off, dtype, dev, gen):
    """A random [side^3, k] block of ``dtype`` on the card: contiguous, or
    columns [off, off + k) of a 24-wide one."""
    import torch

    if off is None:
        return CS.kernel_block(side, k, None, torch.float32, dev, gen).to(
            dtype)
    return CS.kernel_block(side, CS.SLICE_WIDTH, None, torch.float32, dev,
                           gen).to(dtype)[:, off:off + k]


def half_stencil(CS, ST, OST, dev, gen):
    """The f16 and bf16 stencil of both checkouts at ``HALF_STENCIL_SHAPES``
    (side, k, column offset in a 24-wide block or None)."""
    import torch

    rows = []
    for dtype in (torch.float16, torch.bfloat16):
        for side, k, off in HALF_STENCIL_SHAPES:
            X = half_block(CS, side, k, off, dtype, dev, gen)
            g = (side,) * 3
            p = ST.card_plan(X, *g)
            rows.append(compare(
                "stencil3d_" + CS.HALF_SUFFIX[str(dtype).removeprefix("torch.")],
                CS.shape_label(side, k, off), lambda: ST.matmat(X, *g),
                lambda: OST.matmat(X, *g), CS.median_ms, CS._bitwise,
                CS.check, plan=f"kc{p.kc}/vw{p.vw}/tl{p.tl}"))
            del X
    return rows


def extra_times(CS, row, X, library):
    """This checkout's ``copy_ms`` (torch's copy of X) and ``library_ms``
    (``library``, a PyTorch call computing the same function, or None)
    added to ``row``, printed."""
    import torch

    Y = torch.empty_like(X)
    row["copy_ms"] = CS.median_ms(lambda: Y.copy_(X))
    row["library_ms"] = None if library is None else CS.median_ms(library)
    print(f"[turns] {row['entry']} {row['shape']} ({row.get('form', '')}): "
          f"copy {row['copy_ms']:.5f} ms, library "
          + ("none" if library is None else f"{row['library_ms']:.5f} ms"),
          flush=True)
    return row


def half_dia(CS, DK, ODK, dev, gen):
    """The f16 and bf16 DIA entry points and the mixed ones with an f32 and
    an f64 block, of both checkouts, at ``HALF_DIA_SHAPES`` on the
    27-point Laplacian's diagonals (half block: matmat timed, rmatmat bit
    for bit too; mixed: both timed); each row with its bytes bound. The
    half rows at k = 1 and the mixed rows at ``EXTRA_K`` also time
    ``copy_ms`` and cuSPARSE's CSR product of the same matrix in the
    block's type (``library_ms``)."""
    import torch

    rows = []
    for half in (torch.float16, torch.bfloat16):
        sfx = CS.HALF_SUFFIX[str(half).removeprefix("torch.")]
        for side in sorted({s for s, _, _ in HALF_DIA_SHAPES}):
            vals, offs, offsets = CS.laplacian27_dia(side, half, dev)
            for block in (half, torch.float32, torch.float64):
                bsfx = str(block).removeprefix("torch.float")
                entry = "dia_" + sfx + ("" if block == half else "_f" + bsfx)
                for s, k, off in HALF_DIA_SHAPES:
                    if s != side:
                        continue
                    label = CS.shape_label(side, k, off)
                    X = half_block(CS, side, k, off, block, dev, gen)
                    p = DK.card_plan(X, vals)
                    forms = (False, True) if block != half else (False,)
                    if block == half:
                        same = CS._bitwise(
                            DK.matmat(vals, offs, X, adjoint=True),
                            ODK.matmat(vals, offs, X, adjoint=True))
                        CS.check(same, f"{entry} at {label}: the two "
                                 "checkouts' rmatmat differ")
                    for adj in forms:
                        rows.append(compare(
                            entry, label,
                            lambda: DK.matmat(vals, offs, X, adjoint=adj),
                            lambda: ODK.matmat(vals, offs, X, adjoint=adj),
                            CS.median_ms, CS._bitwise, CS.check,
                            form="rmatmat" if adj else "matmat",
                            plan=f"kernel{p.kernel}/kc{p.kc}/vw{p.vw}/"
                            f"rows{p.rows}",
                            bound_ms=dia_bound_ms(CS, vals, X)))
                        if off is None and not adj and (
                                k == 1 if block == half else k == EXTRA_K):
                            csr = CS.dia_csr(vals, offsets, block)
                            extra_times(CS, rows[-1], X, lambda: csr @ X)
                            del csr
                    del X
            del vals, offs
    return rows


def dia_bound_ms(CS, vals, X):
    """The DIA product's bytes bound: vals, X and Y once each."""
    n, k = X.shape
    return round(1e3 * (vals.numel() * vals.element_size()
                        + 2 * n * k * X.element_size()) / CS.HBM_BYTES_PER_S,
                 5)


def half_dia_kernels(CS, DK, dev, gen):
    """This checkout's two half DIA kernels on one column (k = 1, ldx = 1)
    of the 27-point Laplacian at 64^3 and 256^3: the run kernel (the
    plan's) against the rows-32-apart kernel under a plan of scalar
    loads, bit for bit, timed in turns (rows: ``old`` the rows-32-apart
    kernel, ``new`` the run kernel)."""
    import torch

    rows = []
    for half in (torch.float16, torch.bfloat16):
        sfx = CS.HALF_SUFFIX[str(half).removeprefix("torch.")]
        for side in (64, 256):
            vals, offs, _ = CS.laplacian27_dia(side, half, dev)
            X = half_block(CS, side, 1, None, half, dev, gen)
            n = X.shape[0]
            run = DK.card_plan(X)
            CS.check(run.kernel == DK.RUN_KERNEL, "k=1: not the run kernel")
            strided = DK.Plan(1, 1, (-(-n // (DK.THREADS * DK.HALF_ROWS)),
                                     1), DK.HALF_KERNEL)
            Y_run, Y_strided = torch.empty_like(X), torch.empty_like(X)

            def call(p, Y):
                return lambda: (DK.launch(vals, offs, X, Y, False, p), Y)[1]

            rows.append(compare(
                "dia_" + sfx, CS.shape_label(side, 1, None) + " run/strided",
                call(run, Y_run), call(strided, Y_strided), CS.median_ms,
                CS._bitwise, CS.check, plan="old=rows 32 apart, new=run",
                bound_ms=dia_bound_ms(CS, vals, X)))
            del vals, offs, X, Y_run, Y_strided
    return rows


def half_jacobi(CS, JK, OJK, dev, gen):
    """The Jacobi entry points over a half diagonal (f16, bf16) with a
    half, an f32 and an f64 block, shifted and unshifted, of both
    checkouts at 64^3 and 256^3, k in ``HALF_JACOBI_K`` (contiguous
    blocks; the first shift equal to a diagonal entry, as phases 47 and 48
    have them); each row with its bytes bound (X and Y once, d and the
    shifts), and at ``EXTRA_K`` ``copy_ms`` and ``library_ms``
    (``torch.div(X, d[:, None])`` for the unshifted form; none for the
    shifted one)."""
    import torch

    rows = []
    for half in (torch.float16, torch.bfloat16):
        sfx = CS.HALF_SUFFIX[str(half).removeprefix("torch.")]
        for side in (64, 256):
            n = side ** 3
            d = (torch.rand(n, generator=gen, device=dev) * 3 + 0.5).to(half)
            for block in (half, torch.float32, torch.float64):
                bsfx = "" if block == half else \
                    "_f" + str(block).removeprefix("torch.float")
                size = torch.empty((), dtype=block).element_size()
                dw = d.to(block)[:, None]
                for k in HALF_JACOBI_K:
                    X = half_block(CS, side, k, None, block, dev, gen)
                    s = (torch.rand(k, generator=gen, device=dev) * 3
                         + 0.5).to(block)
                    s[0] = d[5]
                    p = JK.card_plan(X, d)
                    for entry, call, nbytes, lib in (
                            ("jacobi_shifted_" + sfx + bsfx,
                             lambda m: m.shifted(X, d, s, 1e-10),
                             2 * n * k * size + 2 * n + k * size, None),
                            ("jacobi_" + sfx + bsfx,
                             lambda m: m.unshifted(X, d, 1e-10),
                             2 * n * k * size + 2 * n,
                             lambda: torch.div(X, dw))):
                        rows.append(compare(
                            entry, CS.shape_label(side, k, None),
                            lambda: call(JK), lambda: call(OJK),
                            CS.median_ms, CS._bitwise, CS.check,
                            plan=f"kernel{p.kernel}/kc{p.kc}/vw{p.vw}/"
                            f"rows{p.rows}",
                            bound_ms=round(1e3 * nbytes / CS.HBM_BYTES_PER_S,
                                           5)))
                        if k == EXTRA_K:
                            extra_times(CS, rows[-1], X, lib)
                    del X
                del dw
            del d
    return rows


def wide_dia(CS, DK, ODK, dev, gen):
    """The f32, f64, complex64 and complex128 DIA entry points of both
    checkouts on the 27-point Laplacian's diagonals at 64^3 and 256^3, k=2
    (matmat timed; rmatmat bit for bit too)."""
    import torch

    def bitwise(a, b):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        return CS._bitwise(a, b)

    rows = []
    for side in (64, 256):
        for dtype in (torch.float32, torch.float64, torch.complex64,
                      torch.complex128):
            vals, offs, _ = CS.laplacian27_dia(side, dtype, dev)
            X = torch.randn((side ** 3, 2), generator=gen, dtype=dtype,
                            device=dev)
            entry = DK._ENTRY[dtype]
            label = CS.shape_label(side, 2, None)
            CS.check(bitwise(DK.matmat(vals, offs, X, adjoint=True),
                             ODK.matmat(vals, offs, X, adjoint=True)),
                     f"{entry} at {label}: the two checkouts' rmatmat differ")
            rows.append(compare(
                entry, label, lambda: DK.matmat(vals, offs, X),
                lambda: ODK.matmat(vals, offs, X), CS.median_ms, bitwise,
                CS.check))
            del vals, X
    return rows


def column_groups(ST, X, g, label, entry_of, median_ms, bitwise, check):
    """The stencil on X under the plan of every column group kc dividing
    k, each bit for bit against the wrapper's output; one row each."""
    import torch

    k = X.shape[1]
    ref = ST.matmat(X, *g)
    rows = []
    for kc in (c for c in (1, 2, 4, 8) if k % c == 0):
        p = ST.plan(*g, k, X.stride(0), X.data_ptr() % 16, X.element_size(),
                    kc)
        Y = torch.empty_like(ref)

        def run():
            ST.launch(X, Y, *g, 1.0, p)

        run()
        check(bitwise(Y, ref), f"stencil3d_{entry_of} at {label}, kc={kc}: "
              "differs from the wrapper's plan")
        ms = median_ms(run)
        rows.append({"entry": "stencil3d_" + entry_of, "shape": label,
                     "kc": kc, "vw": p.vw, "tile": [p.tl, p.tj],
                     "wrapper": kc == ST.card_plan(X, *g).kc, "ms": ms})
        print(f"[groups] stencil3d_{entry_of} {label} kc={kc} vw={p.vw}"
              f"{' (the plan)' if rows[-1]['wrapper'] else ''}: {ms:.5f} ms",
              flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout (the old kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", action="store_true",
                    help="also time the stencil at every column group")
    ap.add_argument("--half-only", action="store_true",
                    help="only the half stencil, DIA and Jacobi rows")
    ap.add_argument("--json", help="file to write every number to")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from primme_tpu_torch.ops import dia as DK
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    OST, OJK, OWE, ODK = load_ops(args.parent, "parent_ops")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = half_stencil(CS, ST, OST, dev, gen)
    rows += half_dia(CS, DK, ODK, dev, gen)
    rows += half_dia_kernels(CS, DK, dev, gen)
    rows += half_jacobi(CS, JK, OJK, dev, gen)
    for dtype in () if args.half_only else (torch.float32, torch.float64):
        suffix = "f32" if dtype == torch.float32 else "f64"
        for side, k, off in CS.KERNEL_SHAPES:
            n, label = side ** 3, CS.shape_label(side, k, off)
            X = CS.kernel_block(side, k, off, dtype, dev, gen)
            d = 1.0 + 10.0 * torch.rand(n, generator=gen, dtype=dtype,
                                        device=dev)
            s = torch.rand(k, generator=gen, dtype=dtype, device=dev)
            s[0] = d[n // 2]
            g = (side, side, side)
            cases = (
                ("stencil3d_" + suffix, lambda m: m.matmat(X, *g),
                 ST, OST, ST.card_plan(X, *g)),
                ("jacobi_shifted_" + suffix,
                 lambda m: m.shifted(X, d, s, 1e-10), JK, OJK,
                 JK.card_plan(X)),
                ("jacobi_" + suffix, lambda m: m.unshifted(X, d, 1e-10),
                 JK, OJK, JK.card_plan(X)))
            for entry, call, mod, old_mod, plan in cases:
                rows.append(compare(
                    entry, label, lambda: call(mod), lambda: call(old_mod),
                    CS.median_ms, CS._bitwise, CS.check,
                    vector_path=plan.vw > 1))
            if args.groups:
                rows += column_groups(ST, X, g, label, entry_of=suffix,
                                      median_ms=CS.median_ms,
                                      bitwise=CS._bitwise, check=CS.check)
            del X, d
    if not args.half_only:
        rows += wide_dia(CS, DK, ODK, dev, gen)
        rows += complex_jacobi(CS, JK, OJK, dev, gen)
        rows += sliced_ell(CS, WE, OWE, dev, gen, args.seed)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "parent": os.path.abspath(args.parent),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
