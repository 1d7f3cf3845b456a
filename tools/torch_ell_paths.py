#!/usr/bin/env python3
"""The sliced-ELL kernel's two paths, ring and direct, on every layout that
``chip_smoke.py`` builds, in turns on one card: the measurement behind
``ops/windowed_ell.py::NARROW_WIDTH``, the mean slice width up to which a
layout takes the direct path.

Layouts (seed 0, the smoke's builders and sizes): the permuted 64^3
27-point Laplacian in f32 and f64 (phases 3 and 5, the windowed pack's
compact layout); the real scatter (phase 13) and the hybrid's remainder
(phase 12), f32; the grounded incidence's ``A`` and ``A^T`` in f32 and f64
(phase 19); the complex scatter in complex64 (phase 26); the magnetic
incidence's ``A`` and ``A^H`` in complex128 (phase 27); the halo operator's
interior and boundary layouts of rank 0 of 2 (phase 41: the 27-point
Laplacian and the banded scatter, f32). At k in {1, 2, 4, 8} both paths
must agree bit for bit; each is timed with ``chip_smoke.median_ms`` in the
order ring, direct, direct, ring. Prints the card's name and power limit,
each layout's mean and max slice width, rows and entries, and one line per
layout and k; with ``--json PATH``, writes every number there.

Run: ``python3 tools/torch_ell_paths.py [--json PATH]``.
"""

import argparse
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (1, 2, 4, 8)


def halo_layouts(A, P=2):
    """Rank 0 of ``P``'s interior and boundary layouts of ``A``'s halo
    operator, with the rows of X each reads: ``{part: (arrays, ncols)}``."""
    from primme_tpu_torch import distributed as D

    pk = D.pack(A, P, True)
    n = pk.cols.shape[0]
    block = -(-n // P)
    comm = types.SimpleNamespace(size=P, rank=0, lo=0, hi=min(block, n),
                                 nl=min(block, n))
    op = D.HaloELLOperator.from_pack(pk, comm)
    from primme_tpu_torch.ops import windowed_ell as WE
    return {key: ([getattr(op, f"{key}_{f}") for f in WE.SlicedELL._fields],
                  op._ncols[key]) for key in op._ncols}


def layouts(seed):
    """``(name, arrays, ncols)`` of every layout, arrays on the host."""
    import numpy as np
    import chip_smoke as CS
    import primme_tpu_torch as ptt
    from primme_tpu_torch.ops import windowed_ell as WE

    fields = WE.SlicedELL._fields
    A, _ = CS.laplacian27(CS.GRID, seed)
    for dt in (np.float32, np.float64):
        op, _ = ptt.rcm_banded(A.astype(dt))
        yield (f"27-point {np.dtype(dt).name}",
               [getattr(op, f) for f in fields], A.shape[1])
    del A
    S = CS.scattered_matrix(CS.GRID ** 3, seed)
    yield "real scatter float32", list(WE.from_csr(S, np.float32)), S.shape[1]
    H = CS.hybrid_matrix(CS.GRID, seed)
    m = CS.GRID
    rem = CS.hybrid_remainder(H, (0, 1, -1, m, -m, m * m, -m * m))
    yield ("hybrid remainder float32", list(WE.from_csr(rem, np.float32)),
           H.shape[1])
    for dt in ("float32", "float64"):
        M = CS.grounded_incidence(CS.SVD_GRID, dtype=dt)[0]
        yield f"svds A {dt}", list(WE.from_csr(M, dt)), M.shape[1]
        MT = M.T.tocsr()
        yield f"svds A^T {dt}", list(WE.from_csr(MT, dt)), MT.shape[1]
    C = CS.complex_scattered_matrix(CS.GRID ** 3, seed)
    yield ("complex scatter complex64", list(WE.from_csr(C, np.complex64)),
           C.shape[1])
    G = CS.magnetic_svd_matrix(CS.MAG_GRID)[0]
    yield ("magnetic incidence A complex128",
           list(WE.from_csr(G, np.complex128)), G.shape[1])
    GH = G.conj().T.tocsr()
    yield ("magnetic incidence A^H complex128",
           list(WE.from_csr(GH, np.complex128)), GH.shape[1])
    for name, M in (("27-point", CS.laplacian27(CS.GRID, seed)[0]),
                    ("banded scatter", CS.band_scatter(*CS.BAND_SCATTER))):
        for part, (arrays, ncols) in halo_layouts(M).items():
            yield f"halo {name} {part} float32", arrays, ncols


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="file to write every number to")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_ell_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from primme_tpu_torch.ops import windowed_ell as WE

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for name, arrays, ncols in layouts(args.seed):
        arrays = [torch.as_tensor(a).to(dev) for a in arrays]
        sp_, rl, cols, vals = arrays
        widths = (sp_[1:] - sp_[:-1]) // WE.SLICE
        info = {"layout": name, "rows": int(rl.shape[0]), "ncols": int(ncols),
                "entries": int(cols.shape[0]), "nnz": int(rl.sum()),
                "mean_width": WE.mean_width(sp_, cols),
                "max_width": int(widths.max()) if widths.numel() else 0,
                "rule": WE.choose_path(sp_, cols)}
        print(f"[layout] {json.dumps(info)}", flush=True)
        size = vals.element_size()
        for k in KS:
            X = torch.randn((ncols, k), generator=gen, dtype=vals.dtype,
                            device=dev)
            ys = {p: WE.matmat(*arrays, X, ncols, path=p) for p in WE.PATHS}
            same = CS._bitwise(torch.view_as_real(ys["ring"])
                               if X.is_complex() else ys["ring"],
                               torch.view_as_real(ys["direct"])
                               if X.is_complex() else ys["direct"])
            CS.check(same, f"{name} k={k}: the paths differ")

            def run(p):
                return lambda: WE.matmat(*arrays, X, ncols, path=p)

            t = [CS.median_ms(run("ring")), CS.median_ms(run("direct")),
                 CS.median_ms(run("direct")), CS.median_ms(run("ring"))]
            bound_ms = 1e3 * (info["nnz"] * (size + 4)
                              + (info["rows"] + ncols) * k * size) \
                / CS.HBM_BYTES_PER_S
            row = dict(info, k=k, bitwise=same, turns_ms=t,
                       ring_ms=(t[0] + t[3]) / 2, direct_ms=(t[1] + t[2]) / 2,
                       bound_ms=bound_ms)
            row["ring_over_direct"] = row["ring_ms"] / row["direct_ms"]
            rows.append(row)
            print(f"[paths] {name} k={k}: ring {t[0]:.5f} {t[3]:.5f} ms, "
                  f"direct {t[1]:.5f} {t[2]:.5f} ms -> ring/direct "
                  f"{row['ring_over_direct']:.3f}; bound {bound_ms:.5f} ms "
                  f"(mean width {info['mean_width']:.2f}, rule "
                  f"{info['rule']})", flush=True)
        del arrays, sp_, rl, cols, vals
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
