"""Worlds of gloo ranks for the port's row-partitioned tests.

:func:`run_world` spawns ``P`` processes (the ``spawn`` start method),
each joining a gloo group through a ``FileStore`` under the test's
``tmp_path`` (no TCP port: the suite runs in parallel workers), builds a
1-D ``DeviceMesh`` of the group and calls one of the ``world_*`` functions
here with it; each rank's returned dict comes back to the caller, in rank
order. The functions import no jax, so ``tests/test_torch_distributed_cuda.py``
runs them on the card machine. The tests here hold the unsharded
:class:`~primme_tpu_torch.distributed.HaloELLOperator` against scipy, in
one process.
"""

import hashlib
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch


def band_matrix(n, halfband, per_row, seed=0):
    """``tests/test_distributed.py``'s ``_band_matrix``: a symmetric
    matrix with scattered nnz inside ``|i - j| <= halfband``, too many
    distinct offsets for the DIA path, a small halo for the partition."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rows + rng.integers(-halfband, halfband + 1, size=rows.size)
    keep = (cols >= 0) & (cols < n)
    A = sp.coo_matrix((rng.normal(size=keep.sum()),
                       (rows[keep], cols[keep])), shape=(n, n))
    return (A + A.T + sp.diags(np.linspace(1, 50, n) + 2 * per_row)).tocsr()


def block_diagonal(n_blocks=8, size=64, seed=2):
    """``tests/test_distributed.py``'s block-diagonal case."""
    blocks = [np.outer(v, v) + np.eye(size) for v in
              np.random.default_rng(seed).normal(size=(n_blocks, size))]
    return sp.block_diag(blocks).tocsr()


def rcm_case():
    """``tests/test_distributed.py``'s band hidden by a permutation."""
    n = 1024
    A0 = band_matrix(n, 4, 3, seed=4)
    p = np.random.default_rng(5).permutation(n)
    return A0[p][:, p].tocsr()


def tridiag(n=400):
    d = np.linspace(1, 80, n)
    return sp.diags([d, 0.2 * np.ones(n - 1), 0.2 * np.ones(n - 1)],
                    [0, 1, -1]).tocsr()


def digest(*arrays) -> str:
    """One hash of the bytes of numpy arrays (every rank's must agree)."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _rank(rank, P, store, fn, args, out, kind):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from primme_tpu_torch.distributed import TIMEOUT

    torch.set_num_threads(1)
    if kind == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", store=dist.FileStore(store, P),
                            rank=rank, world_size=P, timeout=TIMEOUT)
    try:
        mesh = init_device_mesh(kind, (P,))
        res = globals()[fn](mesh, *args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_world(tmp_path, P, fn, *args, kind="cpu"):
    """Run ``world_<fn>(mesh, *args)`` on ``P`` gloo ranks of a ``kind``
    mesh; returns the ranks' dicts. An exception in a rank raises here."""
    import torch.multiprocessing as mp

    out = os.path.join(str(tmp_path), f"{fn}-{P}")
    os.makedirs(out, exist_ok=True)
    mp.spawn(_rank, args=(P, os.path.join(out, "store"), fn, args, out,
                          kind), nprocs=P, join=True)
    res = []
    for r in range(P):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


class _Counting:
    """Counts the point-to-point sends and the all-gathers of a product."""

    def __init__(self):
        import torch.distributed as dist
        self.dist = dist
        self.sends, self.gathers = [], 0
        self._orig = (dist.batch_isend_irecv, dist.all_gather)

    def __enter__(self):
        dist = self.dist
        orig_batch, orig_gather = self._orig

        def batch(ops):
            for o in ops:
                if o.op is dist.isend:
                    self.sends.append(tuple(o.tensor.shape))
            return orig_batch(ops)

        def gather(*a, **k):
            self.gathers += 1
            return orig_gather(*a, **k)

        dist.batch_isend_irecv, dist.all_gather = batch, gather
        return self

    def __exit__(self, *exc):
        self.dist.batch_isend_irecv, self.dist.all_gather = self._orig


def _halo_case(mesh, A, X, try_rcm, dev):
    """One halo case on this rank: its pack, its rows of ``A X`` (``X``
    in the operator's order), the sends and all-gathers the product made."""
    from primme_tpu_torch.distributed import HaloELLOperator

    op, perm = HaloELLOperator.from_scipy(A, mesh, try_rcm=try_rcm)
    comm = op.comm
    Xp = X if perm is None else X[perm]
    x = torch.as_tensor(comm.rows(Xp)).to(dev)
    with _Counting() as c:
        Y = op.matmat(x)
    return op, x, {"cols": op.cols, "vals": op.vals,
                   "diag": op.diag.cpu().numpy(), "halo": op.halo,
                   "hrows": op.hrows, "perm": perm, "split": op.split,
                   "Y": Y.cpu().numpy(), "sends": c.sends,
                   "gathers": c.gathers, "rank": comm.rank,
                   "lo": comm.lo, "hi": comm.hi}


def world_halo(mesh, jax_arrays=None):
    """The halo cases of ``tests/test_distributed.py`` on this rank."""
    from primme_tpu_torch import convert
    from primme_tpu_torch.distributed import mesh_device

    dev = mesh_device(mesh)
    rng = np.random.default_rng(1)
    X8 = rng.normal(size=(1024, 8))
    out = {}
    op, x, out["band"] = _halo_case(mesh, band_matrix(1024, 3, 3), X8,
                                    False, dev)
    # the overlap: the interior rows read this rank's rows alone
    Y = op.matmat(x)
    Yn = torch.full_like(Y, 7.0)
    op.interior(x, Yn)
    nan = torch.full((op.halo, x.shape[1]), float("nan"), dtype=x.dtype,
                     device=x.device)
    op.boundary(x, nan, nan, Yn)
    hr = op.hrows
    out["overlap"] = {"interior_equal": bool(torch.equal(
        Yn[hr:op.nl - hr], Y[hr:op.nl - hr])),
        "boundary_nan": bool(torch.isnan(Yn[:hr]).any()
                             or torch.isnan(Yn[op.nl - hr:]).any()),
        "interior_rows": op.nl - 2 * hr}
    X4 = np.random.default_rng(3).normal(size=(512, 4))
    _, _, out["blockdiag"] = _halo_case(mesh, block_diagonal(), X4, False,
                                        dev)
    X6 = np.random.default_rng(6).normal(size=(1024, 4))
    _, _, out["rcm"] = _halo_case(mesh, rcm_case(), X6, True, dev)
    if jax_arrays is not None:
        # the JAX package's operator, its arrays carried across by rank
        op2 = convert.halo_ell_from_jax(jax_arrays, mesh)
        out["from_jax"] = {"cols": op2.cols, "vals": op2.vals,
                           "Y": op2.matmat(torch.as_tensor(
                               op2.comm.rows(X8)).to(dev)).cpu().numpy()}
    return out


def world_solves(mesh, with_dynamic=True):
    """``tests/test_sharding.py``'s four solves, the halo chooser's solve
    and DYNAMIC under per-rank clocks, on this rank: every output and a
    digest of its bytes."""
    import torch.distributed as dist
    import primme_tpu_torch as ptt
    from primme_tpu_torch.core import comm as cm
    from primme_tpu_torch.core import dynamic

    P = mesh.size()
    out = {}
    w, V, st = ptt.eigsh(tridiag(), k=4, which="SA", tol=1e-9, mesh=mesh,
                         raise_for_unconverged=False, return_stats=True)
    out["tridiag"] = {"w": w, "V": V, "mv": st["num_matvecs"],
                      "gsum": st["num_global_sum"]}
    # the estimated breakdown times this rank's products, the ranks in step
    _, _, stb = ptt.eigsh(tridiag(200), k=2, which="SA", tol=1e-6, mesh=mesh,
                          return_stats=True, time_breakdown=True)
    out["breakdown"] = {"source": stb["time_source"],
                        "matvec": stb["time_matvec"]}
    A = ptt.Stencil3DOperator(16, 8, 8, dtype=torch.float32, device="cpu")
    w2, _ = ptt.eigsh(A, k=3, which="SA", tol=1e-4, mesh=mesh, jacobi=True,
                      raise_for_unconverged=False)
    out["stencil"] = {"w": w2}
    rng = np.random.default_rng(5)
    M = rng.normal(size=(256, 160))
    out["svds_lm"] = {"s": ptt.svds(M, k=3, which="LM", tol=1e-9,
                                    mesh=mesh, return_singular_vectors=False)}
    M2 = np.random.default_rng(6).normal(size=(250, 158))
    U, s, Vt = ptt.svds(M2, k=3, which="SM", tol=1e-9, mesh=mesh)
    out["svds_sm"] = {"U": U, "s": s, "Vt": Vt}
    if P == 4:
        ex0 = cm.EXCHANGES
        Ab = band_matrix(2048, 150, 2, seed=7)
        wb, Vb, stb = ptt.eigsh(Ab, k=4, which="SA", tol=1e-9, mesh=mesh,
                                return_stats=True,
                                raise_for_unconverged=False)
        out["band"] = {"w": wb, "V": Vb, "mv": stb["num_matvecs"],
                       "exchanges": cm.EXCHANGES - ex0}
    if with_dynamic:
        # a fixed-step clock whose step differs by rank: the ranks time
        # their segments differently, and rank 0's choice must rule
        rank = dist.get_rank()

        class Clock:
            t = 0.0
            calls = 0

            @classmethod
            def perf_counter(cls):
                cls.calls += 1
                step = (0.01 if cls.calls % 4 else 0.5) * (1 + 3 * rank)
                cls.t += step if rank % 2 == 0 else 1.0 / step
                return cls.t

        saved = dynamic.time
        dynamic.time = Clock
        try:
            wd, Vd, std = ptt.eigsh(tridiag(300), k=5, which="SA", tol=1e-9,
                                    mesh=mesh, method="DYNAMIC",
                                    return_stats=True)
        finally:
            dynamic.time = saved
        out["dynamic"] = {"w": wd, "trace": std["method_trace"],
                          "seconds": [r["seconds"] for r in
                                      std["dynamic_segments"]]}
    out["digest"] = digest(*[a for case in out.values()
                             for a in case.values()
                             if isinstance(a, np.ndarray)])
    return out


def world_card(mesh):
    """The card's halo product and a small ``eigsh(mesh=)`` on this rank
    (``tests/test_torch_distributed_cuda.py``)."""
    import primme_tpu_torch as ptt
    from primme_tpu_torch.distributed import mesh_device
    from primme_tpu_torch.ops import windowed_ell as WE

    dev = mesh_device(mesh)
    X = np.random.default_rng(1).normal(size=(1024, 8))
    l0 = WE.LAUNCHES
    _, _, halo = _halo_case(mesh, band_matrix(1024, 3, 3), X, False, dev)
    halo["launches"] = WE.LAUNCHES - l0
    w, V = ptt.eigsh(band_matrix(2048, 150, 2, seed=7), k=4, which="SA",
                     tol=1e-9, mesh=mesh, raise_for_unconverged=False)
    return {"halo": halo, "w": w, "V": V}


# --- half operators under a mesh ---------------------------------------------

HALVES = ("float16", "bfloat16")
HALF_GRID = (16, 8, 8)          # the half stencil's grid (x split over ranks)
HALF_BAND = (1024, 3, 3)        # band_matrix's n, half band, entries a row
HALF_K = 2                      # the products' columns


def incidence(m=200, n=120, seed=3):
    """The weighted incidence matrix of a random graph, f32: ``m`` edges
    over ``n`` nodes, edge ``i`` the row ``w_i (e_u - e_v)`` with ``w_i`` in
    {0.5, 1, 1.5, 2} (every entry exact in f16 and bf16)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = (u + rng.integers(1, n, m)) % n
    w = rng.integers(1, 5, m) / 2
    return sp.csr_matrix((np.stack([w, -w], 1).ravel(),
                          (np.repeat(np.arange(m), 2),
                           np.stack([u, v], 1).ravel())),
                         shape=(m, n)).astype(np.float32)


class _Blocks:
    """Records the type of every block the kernels' wrappers are handed
    (``stencil3d.matmat``, ``dia.matmat``, ``windowed_ell.matmat``,
    ``jacobi.shifted``, ``jacobi.unshifted``) while it is entered."""

    def __init__(self):
        from primme_tpu_torch.ops import dia, jacobi, stencil3d
        from primme_tpu_torch.ops import windowed_ell
        # (module, function, the position of its block argument)
        self.where = [(stencil3d, "matmat", 0), (dia, "matmat", 2),
                      (windowed_ell, "matmat", 4), (jacobi, "shifted", 0),
                      (jacobi, "unshifted", 0)]
        self.seen = set()

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.where]
        for (mod, name, arg), fn in zip(self.where, self.saved):
            tag = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"

            def rec(*a, _fn=fn, _arg=arg, _tag=tag, **k):
                self.seen.add((_tag, str(a[_arg].dtype)))
                return _fn(*a, **k)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.where, self.saved):
            setattr(mod, name, fn)


def _half_product(fn, x, unsharded, rows):
    """One sharded product ``fn(x)`` on this rank's rows ``x``: its rows
    (f32 numpy: exact for a half result), type, the wrappers' block types,
    the elements sent, the all-gathers, and whether its rows equal those
    of ``unsharded`` (the unsharded operator's product of the global
    block; None: not compared) bit for bit."""
    from primme_tpu_torch.core import comm as cm

    sent0 = cm.SENT_ELEMENTS
    with _Counting() as c, _Blocks() as b:
        Y = fn(x)
    return {"Y": Y.float().numpy(), "dtype": str(Y.dtype),
            "blocks": sorted(b.seen), "gathers": c.gathers,
            "sent": cm.SENT_ELEMENTS - sent0,
            "bitwise": None if unsharded is None
            else bool(torch.equal(unsharded[rows], Y))}


def world_sharded_half(mesh, ops, halo):
    """The half operators' sharded products and solves on this rank
    (``tests/test_torch_sharded_half.py``): ``ops`` the port's operators
    carried across from the JAX package's by ``convert.py``, by half type
    (``stencil``, ``banded``, ``jacobi``: a ``JacobiPrecond`` of the band's
    diagonal, ``ell``: the band's ``ELLOperator``, ``svd``: the incidence's
    f16 ``ELLOperator``); ``halo`` the JAX package's ``HaloELLOperator``
    arrays of the band with half values, by half type. Products on
    ``HALF_K`` columns in the half type and in f32 (each against the
    unsharded operator's, bit for bit where each row's arithmetic is the
    same); then the solves."""
    from primme_tpu_torch import convert
    from primme_tpu_torch import distributed as D

    out = {"products": {}}
    rng = np.random.default_rng(11)
    n_st = int(np.prod(HALF_GRID))
    n = HALF_BAND[0]
    X = {"stencil": rng.standard_normal((n_st, HALF_K)).astype(np.float32),
         "band": rng.standard_normal((n, HALF_K)).astype(np.float32)}
    for half in HALVES:
        dt = getattr(torch, half)
        o = ops[half]
        comm = D.mesh_comm(mesh, n)
        comm_st = D.mesh_comm(mesh, n_st)
        hop = convert.halo_ell_from_jax(halo[half], mesh)
        sharded = {"stencil": (D.shard_operator(o["stencil"], comm_st),
                               o["stencil"], comm_st),
                   "banded": (D.shard_operator(o["banded"], comm),
                              o["banded"], comm),
                   "halo": (hop, None, comm),
                   "ell": (D.shard_operator(o["ell"], comm), o["ell"],
                           comm)}
        res = out["products"][half] = {
            "types": {k: type(v[0]).__name__ for k, v in sharded.items()}}
        for name, (sop, uop, cm_) in sharded.items():
            Xg = X["stencil" if name == "stencil" else "band"]
            for bt, bname in ((dt, "half"), (torch.float32, "f32")):
                Xb = torch.as_tensor(Xg).to(bt)
                ref = None if uop is None else uop.matmat(Xb)
                res[f"{name}_{bname}"] = _half_product(
                    sop.matmat, cm_.rows(Xb), ref, slice(cm_.lo, cm_.hi))
        # the shift-aware Jacobi on this rank's rows: half block and
        # shifts, then f32 ones (a half basis'), against the unsharded
        K = o["jacobi"]
        Ks = D.shard_operator(K, comm)
        res["types"]["jacobi"] = type(Ks).__name__
        for bt, bname in ((dt, "half"), (torch.float32, "f32")):
            Xb = torch.as_tensor(X["band"]).to(bt)
            sh = torch.stack([K.d[5].to(bt), torch.tensor(0.7, dtype=bt)])
            res[f"jacobi_{bname}"] = _half_product(
                lambda x, _s=sh: Ks.matmat_shifted(x, _s), comm.rows(Xb),
                K.matmat_shifted(Xb, sh), slice(comm.lo, comm.hi))
    out["solves"] = _half_solves(mesh, ops, halo)
    out["digest"] = digest(*[a for case in out["solves"].values()
                             for a in case.values()
                             if isinstance(a, np.ndarray)])
    return out


# the solves of the half operators under a mesh: name -> (operator, half
# type, working type: None for a half basis over the half operator)
HALF_SOLVES = {"stencil_f16": ("stencil", "float16", "float32"),
               "stencil_bf16_half_basis": ("stencil", "bfloat16", None),
               "dia_f16": ("banded", "float16", "float32"),
               "dia_bf16_half_basis": ("banded", "bfloat16", None),
               "halo_bf16": ("halo", "bfloat16", "float32"),
               "halo_f16_half_basis": ("halo", "float16", None)}
HALF_SOLVE_KW = dict(k=4, which="SA", method="PRIMME_JDQMR_ETol",
                     maxBlockSize=2, return_stats=True,
                     raise_for_unconverged=False)


def half_tol(half):
    return 4 * float(torch.finfo(getattr(torch, half)).eps)


def _half_solves(mesh, ops, halo):
    """``HALF_SOLVES`` through ``eigsh(mesh=)`` and ``svds(mesh=)`` of the
    incidence's f16 ``ELLOperator`` (k=3, LM), on this rank."""
    import primme_tpu_torch as ptt
    from primme_tpu_torch import convert

    out = {}
    for name, (kind, half, working) in HALF_SOLVES.items():
        wd = None if working is None else getattr(torch, working)
        kw = dict(HALF_SOLVE_KW, tol=half_tol(half), dtype=wd, mesh=mesh)
        if kind == "stencil":
            A = ops[half]["stencil"]
            kw["OPinv"] = ptt.JacobiPrecond(A.diagonal())
        elif kind == "banded":
            A = ops[half]["banded"]
        else:
            A = convert.halo_ell_from_jax(halo[half], mesh)
        w, V, st = ptt.eigsh(A, **kw)
        out[name] = {"w": w, "V": V, "mv": st["num_matvecs"],
                     "gsum": st["num_global_sum"]}
    U, s, Vh, st = ptt.svds(ops["float16"]["svd"], k=3, which="LM",
                            tol=half_tol("float16"), mesh=mesh,
                            return_stats=True, raise_for_unconverged=False)
    out["svds_f16"] = {"U": U, "s": s, "Vh": Vh,
                       "mv": st["stage1_num_matvecs"]
                       + st.get("stage2_num_matvecs", 0)}
    return out


def _launched(mods):
    """Every wrapper's launch count by entry point, of ``mods``."""
    return {e: c for m in mods for e, c in m.KERNEL_LAUNCHES.items()}


def world_sharded_half_card(mesh):
    """Each half and mixed entry point on its sharded layout on this rank
    of a ``"cuda"`` mesh, against its unsharded launch
    (``tests/test_torch_sharded_half_cuda.py``): the stencil's window of
    x-planes, the DIA window, the Jacobi row slice at a 16-byte aligned
    start (n = 2048) and at an unaligned one (n = 2002), and the halo
    operator's three layouts each launched into its ``out=`` row slice and
    into a block of its own; every product in f16 and bf16 with a half
    and an f32 block. Returns, by case, whether it matched bit for bit and
    the entry points it launched."""
    import primme_tpu_torch as ptt
    from chip_smoke import half_pack
    from primme_tpu_torch import distributed as D
    from primme_tpu_torch.ops import dia as DK
    from primme_tpu_torch.ops import jacobi as JK
    from primme_tpu_torch.ops import stencil3d as ST
    from primme_tpu_torch.ops import windowed_ell as WE

    mods = (ST, DK, JK, WE)
    dev = D.mesh_device(mesh)
    rng = np.random.default_rng(12)
    out = {}

    def case(name, fn):
        l0 = _launched(mods)
        ok = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = {"bitwise": bool(ok), "launches": {
            e: c - l0[e] for e, c in _launched(mods).items() if c > l0[e]}}

    A = band_matrix(*HALF_BAND).astype(np.float32)
    n_st = int(np.prod(HALF_GRID))
    for half in HALVES:
        dt = getattr(torch, half)
        sten = ptt.Stencil3DOperator(*HALF_GRID, dtype=dt, device=dev)
        band = ptt.BandedOperator.from_scipy(A)
        band = ptt.BandedOperator(band.offsets, band.vals.to(dt)).to(dev)
        comm_st = D.mesh_comm(mesh, n_st)
        comm = D.mesh_comm(mesh, A.shape[0])
        forms = {"stencil": (D.shard_operator(sten, comm_st), sten, comm_st,
                             n_st),
                 "dia": (D.shard_operator(band, comm), band, comm,
                         A.shape[0])}
        for bt, bname in ((dt, "half"), (torch.float32, "f32")):
            for name, (sop, uop, c, n) in forms.items():
                X = torch.as_tensor(rng.standard_normal((n, HALF_K))
                                    ).to(device=dev, dtype=bt)
                Yu = uop.matmat(X)[c.lo:c.hi]
                case(f"{name}_{half}_{bname}",
                     lambda: torch.equal(sop.matmat(c.rows(X)), Yu))
            # the Jacobi rows at an aligned and an unaligned start
            for n in (2048, 2002):
                cj = D.mesh_comm(mesh, n)
                d = torch.as_tensor(rng.uniform(0.5, 4, n)).to(device=dev,
                                                                dtype=dt)
                K = ptt.JacobiPrecond(d)
                Ks = D.shard_operator(K, cj)
                X = torch.as_tensor(rng.standard_normal((n, HALF_K))
                                    ).to(device=dev, dtype=bt)
                sh = torch.stack([d[5].to(bt),
                                  torch.tensor(0.7, dtype=bt, device=dev)])
                Yu = K.matmat_shifted(X, sh)[cj.lo:cj.hi]
                Yv = K.matmat(X)[cj.lo:cj.hi]
                x = cj.rows(X).clone()
                case(f"jacobi_{n}_{half}_{bname}", lambda: (
                    torch.equal(Ks.matmat_shifted(x, sh), Yu)
                    and torch.equal(Ks.matmat(x), Yv)))
                out[f"jacobi_{n}_{half}_{bname}"].update(
                    d_offset_bytes=Ks.d.data_ptr() % 16,
                    run_kernel=JK.card_plan(x, Ks.d).kernel == JK.RUN_KERNEL)
            # the halo operator's layouts into their row slices
            pk = half_pack(D.pack(A, mesh.size(), try_rcm=False), dt)
            hop = D.HaloELLOperator.from_pack(pk, comm).to(dev)
            X = torch.as_tensor(rng.standard_normal((A.shape[0], HALF_K))
                                ).to(device=dev, dtype=bt)
            x = comm.rows(X).contiguous()
            y = hop.matmat(x)
            hr, nl = hop.hrows, hop.nl
            left = torch.as_tensor(rng.standard_normal((hop.halo, HALF_K))
                                   ).to(device=dev, dtype=bt)
            right = torch.as_tensor(rng.standard_normal((hop.halo, HALF_K))
                                    ).to(device=dev, dtype=bt)
            xw = torch.cat([left, x, right])

            def layouts():
                Ys = torch.full_like(y, float("nan"))
                hop.interior(x, Ys)
                hop.boundary(x, left, right, Ys)
                return (torch.equal(Ys[hr:nl - hr], hop._run("int", x, None))
                        and torch.equal(Ys[:hr], hop._run("top", xw, None))
                        and torch.equal(Ys[nl - hr:],
                                        hop._run("bot", xw, None)))
            case(f"halo_layouts_{half}_{bname}", layouts)
            out[f"halo_layouts_{half}_{bname}"]["split"] = hop.split
            # the whole sharded product, gathered, and the unsharded ELL
            C = A.tocoo()
            ell = ptt.ELLOperator.from_coo(
                C.row, C.col, torch.from_numpy(C.data).to(dt), A.shape
            ).to(dev)
            out[f"halo_{half}_{bname}"] = {
                "Y": comm.all_gather_rows(y).float().cpu().numpy(),
                "Y_ell": ell.matmat(X).float().cpu().numpy(),
                "dtype": str(y.dtype)}
    return out


# --- the unsharded operator, in one process ---------------------------------

@pytest.mark.parametrize("case", ["band", "blockdiag", "rcm"])
def test_unsharded_halo_operator_matches_scipy(case):
    from primme_tpu_torch.distributed import HaloELLOperator

    A = {"band": lambda: band_matrix(1024, 3, 3),
         "blockdiag": block_diagonal, "rcm": rcm_case}[case]()
    op, perm = HaloELLOperator.from_scipy(A, None, try_rcm=(case == "rcm"))
    assert perm is None and op.halo == 0 and not op.sharded
    X = np.random.default_rng(0).normal(size=(A.shape[0], 5))
    Y = op.matmat(torch.as_tensor(X)).numpy()
    assert np.abs(Y - A @ X).max() <= 1e-12 * abs(A).sum(axis=1).max()
    assert np.array_equal(op.diagonal().numpy(), A.diagonal())


def _fake_mesh(kind, ndim=1):
    """A ``DeviceMesh`` that states only its device type and dimensions
    (no process group): what ``mesh_device`` reads."""
    from torch.distributed.device_mesh import DeviceMesh

    class Fake(DeviceMesh):
        def __init__(self):
            pass

        def __repr__(self):
            return f"Fake({kind!r}, ndim={ndim})"

    Fake.ndim, Fake.device_type = ndim, kind
    return Fake()


def test_mesh_device_refusals(monkeypatch):
    from primme_tpu_torch.distributed import mesh_device

    with pytest.raises(TypeError, match="mesh must be a one-dimensional"):
        mesh_device("x")
    with pytest.raises(TypeError, match="of 2 dimensions"):
        mesh_device(_fake_mesh("cpu", ndim=2))
    assert mesh_device(_fake_mesh("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        mesh_device(_fake_mesh("cpu"), device="cuda")
    # a "cuda" mesh without a card raises; it never runs on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh_device(_fake_mesh("cuda"))
