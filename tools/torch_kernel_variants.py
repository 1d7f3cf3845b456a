#!/usr/bin/env python3
"""Variants of two kernels' designs, timed against each other on one card:
the measurements behind the complex Jacobi kernel's thread shape
(``csrc/jacobi.cu::Shape``) and the sliced-ELL direct path's loads
(``csrc/windowed_ell.cu::sliced_ell_direct``).

* ``tools/jacobi_variants.cu`` (the shipped ``jacobi.cu`` instantiated at
  other shapes): for the four complex entry points at
  ``chip_smoke.JACOBI_COMPLEX_SHAPES`` (complex denominators, as phase 38),
  each shape of columns a thread (one vector, or up to 32 bytes of its row
  group) and rows a thread (1, 2, 4), beside the shipped shape and with
  ``--parent`` the other checkout's kernel; every shape bit for bit with
  the shipped wrapper.
* ``tools/sell_variants.cu`` (the shipped ``windowed_ell.cu`` with its
  direct kernel at each loader: plain, streaming, read-only, L2 only): on
  every layout of ``tools/torch_ell_paths.py`` at k in {1, 2, 4, 8}, beside
  the ring (and with ``--parent`` the other checkout's kernel); every
  loader bit for bit with the ring.

Each case is timed with ``chip_smoke.median_ms``, the first variant again
last to show the card's drift. Prints the card's name and power limit and
one line per case; with ``--json PATH``, writes every number there.

Run: ``python3 tools/torch_kernel_variants.py [--parent _work/parent]
[--only jacobi|ell] [--json PATH]``.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADERS = ("plain", "streaming", "read-only", "L2 only")


def load_variant(name, shipped):
    """Compile ``tools/<name>.cu`` (which includes ``csrc/<shipped>.cu``)
    beside the port's own libraries."""
    from primme_tpu_torch.ops import build

    src = os.path.join(ROOT, "tools", name + ".cu")
    digest = hashlib.sha256()
    for path in (src, os.path.join(build.CSRC, shipped + ".cu")):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(build.BUILD_DIR,
                       f"lib{name}-{digest.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC,
                        "-o", out, src], check=True)
    return ctypes.CDLL(out)


def timed(CS, calls):
    """Median times of each call in order, then the first again."""
    out = {name: CS.median_ms(fn) for name, fn in calls.items()}
    first = next(iter(calls))
    out[first + " (again)"] = CS.median_ms(calls[first])
    return out


def jacobi_variants(CS, JK, OJK, lib, dev, gen):
    import torch

    rows_out = []
    for suffix, tname in CS.JACOBI_COMPLEX:
        dtype = getattr(torch, tname)
        rdt = torch.float32 if suffix == "c64" else torch.float64
        size = 2 * torch.finfo(rdt).bits // 8
        eps_t = ctypes.c_float if suffix == "c64" else ctypes.c_double
        fn = getattr(lib, "jacobi_variant_" + suffix)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 2 + [ctypes.c_longlong, eps_t] \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
            for shifted in (True, False):
                entry = ("jacobi_shifted_" if shifted else "jacobi_") + suffix
                ref = (JK.shifted(X, d, s, 1e-10) if shifted
                       else JK.unshifted(X, d, 1e-10))
                calls = {}
                if OJK is not None:
                    calls["parent"] = (
                        (lambda: OJK.shifted(X, d, s, 1e-10)) if shifted
                        else (lambda: OJK.unshifted(X, d, 1e-10)))
                calls["shipped"] = (
                    (lambda: JK.shifted(X, d, s, 1e-10)) if shifted
                    else (lambda: JK.unshifted(X, d, 1e-10)))
                for group in (0, 1):
                    cols = p.vw if not group else min(p.kc, 32 // size)
                    if group and cols == p.vw:
                        continue
                    for rows in (1, 2, 4):
                        per_block = JK.THREADS // (p.kc // cols) * rows
                        blocks = -(-n // per_block)
                        Y = torch.empty((n, k), dtype=dtype, device=dev)

                        def call(group=group, rows=rows, blocks=blocks, Y=Y):
                            rc = fn(int(shifted), X.data_ptr(), d.data_ptr(),
                                    s.data_ptr(), Y.data_ptr(), n, k,
                                    X.stride(0), 1e-10, p.kc, p.vw, group,
                                    rows, blocks,
                                    torch.cuda.current_stream().cuda_stream)
                            if rc:
                                raise RuntimeError(f"variant: CUDA error {rc}")
                            return Y

                        call()
                        CS.check(CS._bitwise(torch.view_as_real(Y),
                                             torch.view_as_real(ref)),
                                 f"{entry} {label} cols {cols} rows {rows}: "
                                 "differs from the shipped kernel")
                        calls[f"cols{cols}/rows{rows}"] = call
                t = timed(CS, calls)
                rows_out.append({"entry": entry, "shape": label,
                                 "plan": [p.kc, p.vw], "ms": t})
                print(f"[jacobi] {entry} {label} kc={p.kc} vw={p.vw}: "
                      + "  ".join(f"{name} {ms:.5f}" for name, ms in t.items()),
                      flush=True)
            del X, d
    return rows_out


def ell_variants(CS, WE, OWE, lib, dev, gen, seed):
    import torch
    import torch_ell_paths as EP

    out = []
    for suffix in ("f32", "f64", "c64", "c128"):
        fn = getattr(lib, "sell_variant_" + suffix)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name, arrays, ncols in EP.layouts(seed):
        arrays = [torch.as_tensor(a).to(dev) for a in arrays]
        vals = arrays[3]
        fn = getattr(lib, WE._ENTRY[vals.dtype].replace("windowed_ell_spmm",
                                                        "sell_variant"))
        n = arrays[1].shape[0]
        for k in (1, 2, 4, 8):
            X = torch.randn((ncols, k), generator=gen, dtype=vals.dtype,
                            device=dev)
            ring = WE.matmat(*arrays, X, ncols, path="ring")
            as_real = torch.view_as_real if X.is_complex() else (lambda a: a)
            calls = {"ring": lambda: WE.matmat(*arrays, X, ncols,
                                               path="ring")}
            if OWE is not None:
                CS.check(CS._bitwise(as_real(OWE.matmat(*arrays, X, ncols)),
                                     as_real(ring)),
                         f"{name} k={k}: the other checkout's kernel differs")
                calls["parent ring"] = lambda: OWE.matmat(*arrays, X, ncols)
            for li, lname in enumerate(LOADERS):
                Y = torch.empty_like(ring)

                def call(li=li, Y=Y):
                    rc = fn(li, *(a.data_ptr() for a in arrays),
                            X.data_ptr(), Y.data_ptr(), n, k,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"variant: CUDA error {rc}")
                    return Y

                call()
                CS.check(CS._bitwise(as_real(Y), as_real(ring)),
                         f"{name} k={k} {lname}: differs from the ring")
                calls["direct " + lname] = call
            t = timed(CS, calls)
            out.append({"layout": name, "k": k,
                        "mean_width": WE.mean_width(arrays[0], arrays[2]),
                        "ms": t})
            print(f"[ell] {name} k={k} (mean width "
                  f"{out[-1]['mean_width']:.2f}): "
                  + "  ".join(f"{nm} {ms:.5f}" for nm, ms in t.items()),
                  flush=True)
        del arrays
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", help="another checkout (its Jacobi kernel)")
    ap.add_argument("--only", choices=("jacobi", "ell"))
    ap.add_argument("--json", help="file to write every number to")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke as CS
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import windowed_ell as WE

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rec = {"card": smi}
    OJK = OWE = None
    if args.parent:
        from torch_kernel_turns import load_ops
        _, OJK, OWE = load_ops(args.parent, "parent_ops")
    if args.only in (None, "jacobi"):
        rec["jacobi"] = jacobi_variants(
            CS, JK, OJK, load_variant("jacobi_variants", "jacobi"), dev, gen)
    if args.only in (None, "ell"):
        rec["ell"] = ell_variants(
            CS, WE, OWE, load_variant("sell_variants", "windowed_ell"), dev,
            gen, args.seed)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
