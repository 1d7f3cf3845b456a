#!/usr/bin/env python3
"""Time the port's sparse-product kernel against its plain-load variant,
on one card.

``tools/sell_plain_loads.cu`` is the shipped source,
``primme_tpu_torch/csrc/windowed_ell.cu``, with the shared-memory ring taken
out (each lane loads its row's entries straight from device memory through
the same consumer loop). Both are applied to the operator that
``chip_smoke.py`` builds (the 64^3 27-point Laplacian in random node order)
in f32 and f64 at k in {1, 2, 4, 8}; the variant must give the shipped
kernel's result bit for bit. Times are ``chip_smoke.median_ms``, taken in
turns: shipped, variant, variant, shipped. Prints the card's name and power
limit, then one JSON line per type and k.

Run: ``python3 tools/torch_spmm_variants.py``.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANT = os.path.join(ROOT, "tools", "sell_plain_loads.cu")


def load_variant():
    """Compile ``sell_plain_loads.cu`` beside the port's own libraries."""
    from primme_tpu_torch.ops import build

    shipped = os.path.join(build.CSRC, "windowed_ell.cu")
    digest = hashlib.sha256()
    for path in (VARIANT, shipped):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(build.BUILD_DIR,
                       f"libsell_plain_loads-{digest.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC,
                        "-o", out, VARIANT], check=True)
    lib = ctypes.CDLL(out)
    for name in ("sell_plain_spmm_f32", "sell_plain_spmm_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_spmm_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import primme_tpu_torch as ptt
    from primme_tpu_torch.ops import windowed_ell as WE
    from chip_smoke import GRID, laplacian27, median_ms

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    variant = load_variant()
    A, _ = laplacian27(GRID, args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    for dt in (np.float32, np.float64):
        op, _ = ptt.rcm_banded(A.astype(dt))
        op = op.to("cuda")
        entry = WE._ENTRY[op.dtype]
        shipped = WE._spmm_fn(entry)
        plain = getattr(variant, entry.replace("windowed_ell", "sell_plain"))
        n = op.shape[0]
        for k in (1, 2, 4, 8):
            X = torch.randn((n, k), generator=gen, dtype=op.dtype).cuda()

            def call(fn):
                Y = torch.empty_like(X)
                rc = fn(op.slice_ptr.data_ptr(), op.rowlen.data_ptr(),
                        op.cols.data_ptr(), op.vals.data_ptr(),
                        X.data_ptr(), Y.data_ptr(), n, k,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
                return Y

            equal = torch.equal(call(plain), call(shipped))
            t = [median_ms(lambda: call(shipped)),
                 median_ms(lambda: call(plain)),
                 median_ms(lambda: call(plain)),
                 median_ms(lambda: call(shipped))]
            print(json.dumps({"dtype": np.dtype(dt).name, "k": k,
                              "equal": equal, "ring_ms": [t[0], t[3]],
                              "plain_loads_ms": t[1:3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
