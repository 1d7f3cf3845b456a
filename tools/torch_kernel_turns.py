#!/usr/bin/env python3
"""The stencil and Jacobi kernels of this checkout against those of another
checkout (say the parent commit, unpacked with ``git archive`` into the
git-ignored ``_work/parent``), in turns on one card.

For every shape of ``chip_smoke.KERNEL_SHAPES`` (64^3 at k in {1, 2, 4, 8},
128^3 and 256^3 at k in {2, 8}, a k=2 column slice at offset 1 of a
24-wide block), in f32 and f64, for the stencil and both Jacobi entry
points: the two versions' outputs on the same input must agree bit for
bit (NaN for NaN); then each is timed with ``chip_smoke.median_ms``
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
    returns its stencil3d and jacobi modules."""
    pkg = os.path.join(os.path.abspath(checkout), "primme_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(name + ".stencil3d"),
            importlib.import_module(name + ".jacobi"))


def turns(old, new, median_ms):
    """Median times of old, new, new, old; the means of each pair."""
    t = [median_ms(old), median_ms(new), median_ms(new), median_ms(old)]
    return {"turns_ms": t, "old_ms": (t[0] + t[3]) / 2,
            "new_ms": (t[1] + t[2]) / 2, "old_spread_ms": abs(t[0] - t[3]),
            "new_spread_ms": abs(t[1] - t[2])}


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

    OST, OJK = load_ops(args.parent, "parent_ops")
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
                same = CS._bitwise(call(mod), call(old_mod))
                CS.check(same, f"{entry} at {label}: the two checkouts' "
                         "kernels differ")
                row = {"entry": entry, "shape": label,
                       "vector_path": plan.vw > 1, "bitwise": same,
                       **turns(lambda: call(old_mod), lambda: call(mod),
                               CS.median_ms)}
                rows.append(row)
                print(f"[turns] {entry} {label} "
                      f"({'vector' if plan.vw > 1 else 'scalar'} path)"
                      ": old "
                      + " ".join(f"{t:.5f}" for t in row["turns_ms"][::3])
                      + " ms, new " + " ".join(
                          f"{t:.5f}" for t in row["turns_ms"][1:3])
                      + f" ms -> {row['old_ms']:.5f} / {row['new_ms']:.5f}"
                      f" = {row['old_ms'] / row['new_ms']:.3f}x", flush=True)
            if args.groups:
                rows += column_groups(ST, X, g, label, entry_of=suffix,
                                      median_ms=CS.median_ms,
                                      bitwise=CS._bitwise, check=CS.check)
            del X, d
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "parent": os.path.abspath(args.parent),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
