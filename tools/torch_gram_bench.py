#!/usr/bin/env python3
"""Times ``core.linalg.gram`` on the card at the basis shapes of the
port's solves, beside the product it avoids.

For each type (f32, f64, complex64, complex128), basis width m (24, the
smoke's eigsh basis, and 15, eigs' default at k=7) and block width (1
and 2 columns) it times, on an ``[n, m]`` basis ``V`` and an ``[n, k]``
block ``Y`` (n = 262,144, standard normal): ``gram(V, Y)`` as shipped,
the plain ``V^H Y`` (``V.mH @ Y``, in double for the single-precision
types as ``gram`` sums), ``gram(Y, V)`` and ``block_ortho`` of one
block against ``V``. Each time is the mean of 20 calls after a warm-up,
between synchronisations. Prints the card's name and power limit, then
one JSON object of milliseconds. Run: ``python3
tools/torch_gram_bench.py`` (needs a card).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mean_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_gram_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from primme_tpu_torch.core import linalg as TL

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}
    dev, n, out = "cuda", 262144, {}
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128):
        w = wide.get(dt, dt)
        for m in (15, 24):
            V = torch.randn(n, m, dtype=dt, device=dev)
            for k in (1, 2):
                Y = torch.randn(n, k, dtype=dt, device=dev)
                key = f"{str(dt)[6:]} m={m} k={k}"
                out[key + " gram(V,Y)"] = mean_ms(lambda: TL.gram(V, Y))
                out[key + " plain V^H Y"] = mean_ms(
                    lambda: (V.to(w).mH @ Y.to(w)).to(dt))
                out[key + " gram(Y,V)"] = mean_ms(lambda: TL.gram(Y, V))
                out[key + " block_ortho"] = mean_ms(
                    lambda: TL.block_ortho(Y, V, None, k,
                                           torch.Generator().manual_seed(0)),
                    reps=5)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
