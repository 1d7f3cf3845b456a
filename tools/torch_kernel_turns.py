#!/usr/bin/env python3
"""The stencil, Jacobi and sliced-ELL kernels of this checkout against those
of another checkout (say the parent commit, unpacked with ``git archive``
into the git-ignored ``_work/parent``), in turns on one card.

For every shape of ``chip_smoke.KERNEL_SHAPES`` (64^3 at k in {1, 2, 4, 8},
128^3 and 256^3 at k in {2, 8}, a k=2 column slice at offset 1 of a
24-wide block), in f32 and f64, for the stencil and both Jacobi entry
points; for the four complex Jacobi entry points at
``chip_smoke.JACOBI_COMPLEX_SHAPES`` (complex denominators, the first shift
on a diagonal entry, as phase 38 has them); and for the sliced-ELL kernel
at k in {1, 2, 4, 8} on the complex scatter (complex64, phase 26), the
magnetic incidence's ``A`` and ``A^H`` (complex128, phase 27), the
grounded incidence's ``A`` in f32 and f64 (phase 19) and the permuted
27-point Laplacian in f32 and f64 (phases 3 and 5), each wrapper on its
default path: the two versions' outputs on the same input must agree bit
for bit (NaN for NaN); then each is timed with ``chip_smoke.median_ms``
(behind the spin) in the order old, new, new, old, so that a drift of the
card's clocks falls on both. The other checkout's ``primme_tpu_torch/ops``
is imported under another name and builds its own sources into its own
``_build/``. Prints one line per case and the card's name and power limit;
with ``--json PATH``, writes every number there.

With ``--groups``, the stencil of this checkout is also timed, at every
shape, under the plan of each column group a point may hold (``kc`` of 1,
2, 4, 8 dividing k; ``ops/stencil3d.py::plan``'s ``kc``), each checked bit
for bit against the wrapper's output: the measurement behind the plan's
rule (the largest group that divides k). Rerun it before changing that
rule.

Run: ``python3 tools/torch_kernel_turns.py --parent _work/parent
[--groups] [--json PATH]``.
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
    returns its stencil3d, jacobi and windowed_ell modules."""
    pkg = os.path.join(os.path.abspath(checkout), "primme_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.{mod}")
                 for mod in ("stencil3d", "jacobi", "windowed_ell"))


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
    ap.add_argument("--json", help="file to write every number to")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    OST, OJK, OWE = load_ops(args.parent, "parent_ops")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for dtype in (torch.float32, torch.float64):
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
    rows += complex_jacobi(CS, JK, OJK, dev, gen)
    rows += sliced_ell(CS, WE, OWE, dev, gen, args.seed)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "parent": os.path.abspath(args.parent),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
