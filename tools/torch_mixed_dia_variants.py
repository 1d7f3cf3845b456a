#!/usr/bin/env python3
"""Thread maps and offset schemes of the mixed DIA product, timed against
one another on one card: the measurement behind
``primme_tpu_torch/csrc/dia.cu::dia_mixed_kernel``.

The variants (``tools/mixed_dia_variants.cu``, built here) compute the
product of bf16 values with an f32 block of k = 2 columns (matmat) with
dia_kernel's arithmetic: one row a thread with the offsets loaded from
device memory (dia_kernel's loop), staged in shared memory as 32-bit
shifts, or passed as kernel parameters (an upper bound: it needs the
offsets on the host); two or four adjacent rows a thread (their values
in one load, their rows of X in 16-byte chunks); two rows 32 apart; one
row a thread with the loads of 8, 9 or 16 diagonals staged before their
sums. Beside them the port's ``dia_bf16_f32`` under its plan
(``MIXED_KERNEL``) and under dia_kernel's (``ROW_KERNEL``). On the
27-point Laplacian's 27 diagonals (``chip_smoke.laplacian27_dia``) at
64^3 and 256^3; every output is checked bit for bit against the port's,
then each is timed with ``chip_smoke.median_ms`` twice, in the order of
the list and then reversed, and the mean reported. Prints the card's name
and power limit and one line a variant; with ``--json PATH`` writes them
there.

Run: ``python3 tools/torch_mixed_dia_variants.py [--json PATH]``.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tools", "mixed_dia_variants.cu")
VARIANTS = ("one row, offsets from device memory (dia_kernel's loop)",
            "one row, offsets in shared memory",
            "one row, offsets as kernel parameters, unrolled whole",
            "two adjacent rows", "four adjacent rows", "two rows 32 apart",
            "one row, shared offsets, 8 diagonals staged",
            "one row, shared offsets, 9 diagonals staged",
            "one row, shared offsets, 16 diagonals staged")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="file to write every number to")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_mixed_dia_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from primme_tpu_torch.ops import build
    from primme_tpu_torch.ops import dia as DK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    fn = build.load_source(SOURCE, "mixed_dia_variants").mixed_dia_variant
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for side in (64, 256):
        vals, offs, offsets = CS.laplacian27_dia(side, torch.bfloat16, dev)
        n = side ** 3
        X = torch.randn((n, 2), generator=gen, device=dev)
        o32 = offs.to(torch.int32)
        host = (ctypes.c_int * len(offsets))(*offsets)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ref = DK.matmat(vals, offs, X)
        calls = {}
        for v, name in enumerate(VARIANTS):
            Y = torch.empty_like(X)

            def call(v=v, Y=Y):
                rc = fn(v, vals.data_ptr(), offs.data_ptr(), o32.data_ptr(),
                        host, len(offsets), X.data_ptr(), Y.data_ptr(), n,
                        stream)
                CS.check(rc == 0, f"variant {v}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            CS.check(CS._bitwise(Y, ref), f"variant {v} ({name}) at "
                     f"{side}^3 differs from the port's kernel")
            calls[name] = call
        for kernel, name in ((DK.MIXED_KERNEL, "the port: dia_mixed_kernel"),
                             (DK.ROW_KERNEL, "the port: dia_kernel")):
            p = DK.card_plan(X, vals)._replace(kernel=kernel)
            Y = torch.empty_like(X)
            calls[name] = (lambda p=p, Y=Y:
                           DK.launch(vals, offs, X, Y, False, p))
            calls[name]()
            CS.check(CS._bitwise(Y, ref), f"{name} under plan {p}")
        order = list(calls)
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            times[name].append(CS.median_ms(calls[name]))
        for name in order:
            ms = sum(times[name]) / 2
            rows.append({"shape": f"{side}^3 k=2", "variant": name,
                         "ms": ms, "turns_ms": times[name]})
            print(f"[variants] {side}^3 k=2 {name}: {ms:.5f} ms "
                  f"({times[name][0]:.5f}, {times[name][1]:.5f})", flush=True)
        del vals, offs, X, ref, calls
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
