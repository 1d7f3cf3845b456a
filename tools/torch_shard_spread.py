#!/usr/bin/env python3
"""The spread of svds' SM stage 2 under rounding, unsharded and sharded.

``chip_smoke.py`` phase 44 runs ``svds(k=4, which="SM", tol=1e-8)`` on
``grounded_incidence(N)`` under a 2-rank mesh. Its stage 2 refines a
triple-degenerate cluster, and its matvec count moves with the rounding
of its start. This script measures that: it runs the call unsharded and
on 2 gloo ranks (CPU, spawned, a ``FileStore`` rendezvous), each once as
it is and then with the stage-2 start block multiplied entrywise by ``1 +
eps z`` (``z`` standard normal from a seed) for each ``(eps, seed)`` of
``--perturb``, and prints each run's stage-2 matvecs.

``--package jax`` puts the same call and the same perturbations (the same
``z``, drawn by torch from the same seeds) through the JAX package's
``svds`` on the CPU: unsharded on one device, and sharded over a mesh of
``--ranks`` of the CPU devices that ``XLA_FLAGS``'
``--xla_force_host_platform_device_count`` makes (set here to 4 before
JAX starts, as ``tests/conftest.py`` sets it), with no edit to the
package: its ``svds`` module's ``solve_eigs`` is wrapped as the port's is.

    python3 tools/torch_shard_spread.py --grid 32
    python3 tools/torch_shard_spread.py --grid 32 --package jax --ranks 4
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PERTURB = ((0.0, 0), (1e-14, 1), (1e-14, 2), (1e-14, 3), (1e-12, 4),
           (1e-12, 5))


def _perturbing(grid, tag, eps):
    """Wrap ``svds``' ``solve_eigs`` so that the stage-2 start block moves
    by ``eps``, and print each stage 2's matvecs."""
    import torch
    import primme_tpu_torch  # noqa: F401
    S = sys.modules["primme_tpu_torch.svds"]
    orig = S.solve_eigs

    def solve_eigs(Aop, p, **kw):
        stage2 = p.n != grid ** 3
        v0, comm = kw.get("v0"), kw.get("comm")
        if stage2 and v0 is not None and eps[0]:
            z = torch.randn((p.n, v0.shape[1]), dtype=v0.dtype,
                            generator=torch.Generator().manual_seed(eps[1]))
            kw["v0"] = v0 * (1 + eps[0] * (z if comm is None
                                           else comm.rows(z)))
        r = orig(Aop, p, **kw)
        if stage2 and tag:
            print(f"{tag} eps {eps[0]:g} seed {eps[1]}: stage 2 "
                  f"{r.stats.num_matvecs} matvecs", flush=True)
        return r

    S.solve_eigs = solve_eigs


def _jax_spread(grid, ranks):
    """The JAX package's stage-2 matvecs under the same perturbations,
    unsharded and over a ``ranks``-device CPU mesh."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch
    import chip_smoke as CS
    import primme_tpu as pt
    S = sys.modules["primme_tpu.svds"]
    orig = S.solve_eigs
    eps, tag = [0.0, 0], [""]

    def solve_eigs(Aop, p, **kw):
        stage2 = p.n != grid ** 3
        v0 = kw.get("v0")
        if stage2 and v0 is not None and eps[0]:
            z = torch.randn((p.n, v0.shape[1]), dtype=torch.float64,
                            generator=torch.Generator().manual_seed(eps[1]))
            moved = v0 * (1 + eps[0] * jnp.asarray(z.numpy(), v0.dtype))
            sharding = getattr(v0, "sharding", None)
            kw["v0"] = (moved if sharding is None
                        else jax.device_put(moved, sharding))
        r = orig(Aop, p, **kw)
        if stage2:
            print(f"{tag[0]} eps {eps[0]:g} seed {eps[1]}: stage 2 "
                  f"{int(r.stats.num_matvecs)} matvecs", flush=True)
        return r

    S.solve_eigs = solve_eigs
    A, _ = CS.grounded_incidence(grid)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:ranks]), ("rows",))
    for label, kw in (("jax unsharded", {}),
                      (f"jax sharded P={ranks}", {"mesh": mesh})):
        tag[0] = label
        for e in PERTURB:
            eps[:] = list(e)
            pt.svds(A, k=4, which="SM", tol=1e-8, **kw)


def _rank(rank, P, store, grid):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import chip_smoke as CS
    import primme_tpu_torch as ptt

    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P)
    try:
        eps = [0.0, 0]
        _perturbing(grid, f"sharded P={P}" if rank == 0 else "", eps)
        mesh = init_device_mesh("cpu", (P,))
        A, _ = CS.grounded_incidence(grid)
        for e in PERTURB:
            eps[:] = list(e)
            ptt.svds(A, k=4, which="SM", tol=1e-8, mesh=mesh)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    args = ap.parse_args()
    if args.package == "jax":
        _jax_spread(args.grid, args.ranks)
        return 0

    import torch
    import torch.multiprocessing as mp
    import chip_smoke as CS
    import primme_tpu_torch as ptt

    torch.set_num_threads(4)
    eps = [0.0, 0]
    _perturbing(args.grid, "unsharded", eps)
    A, _ = CS.grounded_incidence(args.grid)
    for e in PERTURB:
        eps[:] = list(e)
        ptt.svds(A, k=4, which="SM", tol=1e-8, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(args.ranks, os.path.join(tmp, "store"),
                              args.grid), nprocs=args.ranks, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
