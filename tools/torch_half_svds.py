#!/usr/bin/env python3
"""``svds`` of a half matrix through both packages, on the CPU: the verdict
on whether the JAX package computes it right, which decides whether the
port serves it.

A seeded 400 x 200 sparse matrix (density 0.03, entries multiples of
1/8 in [0.125, 8.125], exact in both half types) as an ``ELLOperator``
in f16 and in bf16 (the JAX package's ``(cols, vals)`` constructor; the
port's ``convert.ell_from_jax``), ``svds(k=3, which="LM", tol=4
eps(half))`` with seeds 0-2 in each package. Prints one JSON line a run:
each stage's matvecs, the largest distance of the values from numpy's
singular values, the triplet residuals ``hypot(|A v - s u|, |A^T u - s
v|)`` in f64 against the exact matrix, and the half basis' gate ``16
eps(half) ||A||``.

    python3 tools/torch_half_svds.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp

    import primme_tpu as pt
    from primme_tpu import operators as JO
    import primme_tpu_torch as ptt
    from primme_tpu_torch import convert as CV

    A = sp.random(400, 200, density=0.03, random_state=0, format="csr")
    A.data = np.round(A.data * 8) / 8 + 0.125
    sv = np.linalg.svd(A.toarray(), compute_uv=False)
    cols, vals = JO.ELLOperator._pack(A)
    colsT, valsT = JO.ELLOperator._pack(A.T.tocsr())
    for half in ("float16", "bfloat16"):
        hd = jnp.dtype(half)
        eps = float(jnp.finfo(hd).eps)
        jop = JO.ELLOperator(cols, jnp.asarray(vals).astype(hd),
                             shape=A.shape, colsT=colsT,
                             valsT=jnp.asarray(valsT).astype(hd))
        top = CV.ell_from_jax(jop)
        for package, fn, extra in (("jax", pt.svds, {}),
                                   ("port", ptt.svds, {"device": "cpu"})):
            for seed in (0, 1, 2):
                U, s, Vh, st = fn(jop if package == "jax" else top, k=3,
                                  which="LM", tol=4 * eps, seed=seed,
                                  return_stats=True,
                                  raise_for_unconverged=False, **extra)
                U, s, V = (np.asarray(x, np.float64)
                           for x in (U, s, np.asarray(Vh).T))
                res = np.hypot(np.linalg.norm(A @ V - U * s, axis=0),
                               np.linalg.norm(A.T @ U - V * s, axis=0))
                print(json.dumps({
                    "package": package, "half": half, "seed": seed,
                    "stage1_matvecs": int(st.get("stage1_num_matvecs", 0)),
                    "stage2_matvecs": int(st.get("stage2_num_matvecs", 0)),
                    "value_err": float(np.abs(np.sort(s)[::-1]
                                              - sv[:3]).max()),
                    "residuals": res.tolist(),
                    "gate": 16 * eps * float(sv[0])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
