#!/usr/bin/env python3
"""The JAX package's counts for ``chip_smoke.py``'s sparse-format phases,
computed on the CPU: the constants the smoke run holds the port to.

For each phase it builds the phase's matrix with ``chip_smoke.py``'s own
function and runs ``primme_tpu.eigsh`` with the phase's arguments
(``chip_smoke.SOLVE_KWARGS``, tol 1e-5, seed 0; x64 on, the solve in the
matrix's type, f32 unless said):

* ``banded``: the 64^3 27-point Laplacian in grid order (the chooser's
  banded branch);
* ``hybrid``: ``chip_smoke.hybrid_matrix(64, 0)`` (the DIA+ELL branch);
* ``ell``: ``chip_smoke.scattered_matrix(262144, 0)`` in f64, passed as
  the ``ELLOperator`` that the reference's ``aslinearoperator`` builds for
  it once its chooser returns None (that chooser first tries the windowed
  pack, whose count array alone takes 2.1 GB at this size; the port's run
  on the card checks the chooser's verdict itself). f64, because the
  reference's f32 solve of this matrix stagnates (2000 matvecs here, 5975
  at n = 65,536, where its f64 solve takes 518): its f64 counts and
  eigenvalues are the converging algorithm's;
* ``ell_f32``: the same in f32, the stagnating run, for the record.

Prints one JSON object per phase (``num_matvecs``, the ten eigenvalues, the
chosen operator's class, seconds). Run from the repository root, on a
machine with JAX (no card needed):

    python3 tools/torch_smoke_refs.py [--phase banded|hybrid|ell|ell_f32]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("banded", "hybrid", "ell",
                                        "ell_f32"), action="append")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    import chip_smoke as CS
    import primme_tpu as pt
    from primme_tpu import operators as JO

    for phase in args.phase or ("banded", "hybrid", "ell", "ell_f32"):
        t0 = time.perf_counter()
        if phase == "banded":
            A = CS.laplacian27_grid(CS.GRID)[0]
        elif phase == "hybrid":
            A = CS.hybrid_matrix(CS.GRID, 0)
        else:
            A = CS.scattered_matrix(CS.GRID ** 3, 0)
            A = JO.ELLOperator.from_scipy(
                A.astype(np.float64) if phase == "ell" else A)
        if phase.startswith("ell"):
            chosen = type(A).__name__
        else:
            chosen = type(JO.rcm_banded(A)[0]).__name__
        w, _, st = pt.eigsh(A, tol=1e-5, seed=0, **CS.SOLVE_KWARGS)
        print(json.dumps({"phase": phase, "operator": chosen,
                          "num_matvecs": int(st["num_matvecs"]),
                          "num_probe_matvecs": int(st["num_probe_matvecs"]),
                          "evals": [float(x) for x in np.sort(np.asarray(w))],
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
