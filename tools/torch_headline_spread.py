#!/usr/bin/env python3
"""The headline's matvec counts through both packages on the CPU, over
grids and seeds: does the port take more matvecs than the JAX package
systematically, or within the spread of their random streams?

For each grid side m and seed s it runs ``bench.py``'s configuration (the
7-point Laplacian of an m^3 grid with the shift-aware Jacobi
preconditioner, k=10 smallest, JDQMR_ETol, block 2, basis 24, restart 14,
tol 1e-5, f32, probe on) with ``v0 = default_rng(s).normal((n, 2))`` and
``rng_seed = s``, through ``primme_tpu``'s ``solve_eigs`` (x64 off, as
``bench.py`` runs) and through ``primme_tpu_torch``'s on the CPU (one torch
thread), and prints one JSON line per run: matvecs, probe matvecs and
rounds, outer and inner iterations, and the largest eigenvalue error
against the closed form.

    python3 tools/torch_headline_spread.py --grids 24 32 48 --seeds 0 1 2 3 4
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def closed_form(m, k):
    import numpy as np

    ax = 2 - 2 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    return np.sort((ax[:, None, None] + ax[None, :, None]
                    + ax[None, None, :]).ravel())[:k]


def run_jax(m, seed):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from primme_tpu import (JacobiPrecond, Method, PrimmeParams,
                            Stencil3DOperator, set_method)
    from primme_tpu.core.inner import jdqmr_inner_solve
    from primme_tpu.core.solver import solve_eigs

    n = m ** 3
    A = Stencil3DOperator(m, m, m, dtype=jnp.float32)
    K = JacobiPrecond(A.diagonal())
    p = PrimmeParams(n=n, num_evals=10, eps=1e-5, max_basis_size=24,
                     max_block_size=2, min_restart_size=14,
                     max_matvecs=16000, locking=0, rng_seed=seed)
    p = set_method(Method.JDQMR_ETol, p, has_precond=True)
    v0 = jnp.asarray(np.random.default_rng(seed).normal(size=(n, 2)),
                     jnp.float32)
    res = jax.jit(lambda v: solve_eigs(A, p, K=K, v0=v, dtype=jnp.float32,
                                       inner_solve=jdqmr_inner_solve))(v0)
    return res.evals, res.stats


def run_torch(m, seed):
    import numpy as np
    import torch
    import primme_tpu_torch as ptt
    from primme_tpu_torch.core.inner import jdqmr_inner_solve

    n = m ** 3
    A = ptt.Stencil3DOperator(m, m, m, dtype=torch.float32, device="cpu")
    K = ptt.JacobiPrecond(A.diagonal())
    p = ptt.PrimmeParams(n=n, num_evals=10, eps=1e-5, max_basis_size=24,
                         max_block_size=2, min_restart_size=14,
                         max_matvecs=16000, locking=0, rng_seed=seed)
    p = ptt.set_method(ptt.Method.JDQMR_ETol, p, has_precond=True)
    v0 = torch.as_tensor(np.random.default_rng(seed).normal(size=(n, 2)),
                         dtype=torch.float32)
    res = ptt.solve_eigs(A, p, K=K, v0=v0, dtype=torch.float32,
                         inner_solve=jdqmr_inner_solve, device="cpu")
    return res.evals, res.stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grids", type=int, nargs="+", default=[24, 32, 48])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--package", choices=("jax", "torch", "both"),
                    default="both")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    torch.set_num_threads(1)
    runs = {"jax": run_jax, "torch": run_torch}
    for m in args.grids:
        lam = closed_form(m, 10)
        for seed in args.seeds:
            for pkg in (("jax", "torch") if args.package == "both"
                        else (args.package,)):
                t0 = time.perf_counter()
                evals, st = runs[pkg](m, seed)
                err = float(np.abs(np.sort(np.asarray(evals)) - lam).max())
                print(json.dumps({
                    "grid": m, "seed": seed, "package": pkg,
                    "num_matvecs": int(st.num_matvecs),
                    "num_probe_matvecs": int(st.num_probe_matvecs),
                    "num_probe_rounds": int(st.num_probe_rounds),
                    "outer": int(st.num_outer_iterations),
                    "inner": int(st.num_inner_iterations),
                    "eval_err": err,
                    "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
