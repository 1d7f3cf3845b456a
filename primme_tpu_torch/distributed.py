"""The row-partitioned solve: halo-exchange SpMM and sharded operators
over ``torch.distributed``.

PyTorch port of ``primme_tpu/distributed.py`` and of the ``mesh=`` path of
``eigsh`` and ``svds``. The reference's whole parallel model is a 1-D row
partition in which each rank owns ``nLocal`` rows and the user's matvec
moves only boundary data (``include/primme_eigs.h:188-198``; the PETSc
driver ``tests/COMMON/petscw.c``). The JAX package gets it from GSPMD:
``psum`` behind every reduction over rows, ``ppermute`` for the shifts of
the stencil and the banded layout, and, written by hand,
:class:`HaloELLOperator`'s exchange of ``h`` rows with each neighbour.
The port runs it as explicit SPMD, the reference's own model: every rank
calls the entry point with the same global input, packs on the host,
keeps its own rows, and solves with a :class:`~.core.comm.RowComm` that
sums every reduction over rows (:mod:`.core.comm`).

``mesh`` is a one-dimensional ``torch.distributed.device_mesh.DeviceMesh``
(the counterpart of a JAX ``Mesh``). Its device type places the blocks:
``"cuda"`` on ``cuda:{rank % device_count}``, ``"cpu"`` on the host.
Rows split into contiguous blocks of ``ceil(n / P)``, the last shorter;
:class:`HaloELLOperator` keeps its own rule that ``n % P == 0``.

Sharded operators (:func:`shard_operator`): the halo-exchange ELL (the
sliced-ELL kernel on two layouts, the interior launched while the
exchange is in flight), the 7-point stencil split over x-planes (one
plane exchanged with each neighbour, the stencil kernel on the window),
the banded layout (a halo of ``max |offset|`` rows, the DIA kernel on the
window), the Jacobi and diagonal operators on their own rows, and every
other operator through an all-gather of the block (what GSPMD does to the
JAX package's global-gather formats). Every one of them takes f16 and bf16
operators as the unsharded operators do: a half operator given a half
block runs its kernel's half entry point, given a wider real block (a half
basis hands it f32 ones) the mixed entry point from its half values, as
the JAX package's products promote; the stencil alone casts the block to
its own type, in both packages. The exchanges carry the block in its own
type.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the communication helpers live beside the solver, which sums with them
from .core.comm import (RowComm, allgather_rows, global_sum,  # noqa: F401
                        halo_exchange, rows_of)
from .ops import dia as DK
from .ops import stencil3d as ST
from .ops import windowed_ell as WE
from .convert import tensor_from_numpy
from .operators import (_HALF, BandedOperator, CastOperator, DenseOperator,
                        DiagonalOperator, ELLOperator, JacobiPrecond,
                        LinearOperator, Stencil3DOperator,
                        _as_tensor, _compute_dtype, _kernel_block, _on_parts,
                        _result_dtype, densified)

# a desync (a rank that branches differently) fails a collective after
# this long instead of hanging
TIMEOUT = datetime.timedelta(seconds=120)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def mesh_device(mesh, device: Any = None) -> torch.device:
    """The device of this rank's blocks under ``mesh``, a 1-D
    ``DeviceMesh``: ``cuda:{rank % device_count}`` for a ``"cuda"`` mesh
    (raising without a card), the CPU for a ``"cpu"`` one. A ``device``
    that names another device type raises."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(
            f"mesh must be a one-dimensional torch.distributed.device_mesh."
            f"DeviceMesh, got {type(mesh).__name__}"
            + (f" of {mesh.ndim} dimensions" if isinstance(mesh, DeviceMesh)
               else ""))
    kind = mesh.device_type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh is a \"cuda\" mesh and "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"mesh of device type {kind!r} (cuda or cpu only)")
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device={device!r} disagrees with the mesh's "
                         f"device type {kind!r}")
    return dev


def mesh_comm(mesh, n: int, device: Any = None) -> Optional[RowComm]:
    """The row communicator of an ``n``-row solve under ``mesh``; None for
    a mesh of one rank (the unsharded path)."""
    dev = mesh_device(mesh, device)
    if mesh.size() == 1:
        return None
    return RowComm(mesh.get_group(), n, dev)


# ---------------------------------------------------------------------------
# HaloELLOperator
# ---------------------------------------------------------------------------

class HaloPack(NamedTuple):
    """The JAX package's ``HaloELLOperator`` arrays for a ``P``-rank
    partition, global: window-relative ``cols`` ``[n, w]`` (padding holds
    index ``h``, value 0), ``vals`` ``[n, w]``, ``diag`` ``[n]`` (numpy, or
    CPU tensors: half values), the halo width ``h``, the boundary-row
    thickness ``hrows`` and the RCM permutation ``perm`` (or None)."""
    cols: np.ndarray
    vals: np.ndarray
    diag: np.ndarray
    halo: int
    hrows: int
    perm: Optional[np.ndarray]


def _halo_width(A, nl: int) -> int:
    """Max reach of any nnz outside its row's shard block (the JAX
    package's ``HaloELLOperator._halo_width``)."""
    C = A.tocoo()
    if C.nnz == 0:
        return 0
    start = (C.row // nl).astype(np.int64) * nl
    below = start - C.col
    above = C.col - (start + nl - 1)
    return int(max(0, below.max(initial=0), above.max(initial=0)))


def pack(A, nsh: int, try_rcm: bool = True) -> Optional[HaloPack]:
    """The JAX package's ``HaloELLOperator.from_scipy`` packing for an
    ``nsh``-rank partition, as numpy: the same arrays for the same matrix.
    None when ``n % nsh != 0`` or the halo exceeds one rank's rows even
    after RCM; the RCM order is kept when it shrinks the halo."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1] or n % nsh != 0:
        return None
    nl = n // nsh
    perm = None
    h = _halo_width(A, nl)
    if try_rcm:
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        p = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[p][:, p]
        hp = _halo_width(Ap, nl)
        if hp < h:
            A, h, perm = Ap.tocsr(), hp, p
    if h > nl:
        return None
    row_nnz = np.diff(A.indptr)
    w = max(int(row_nnz.max()), 1)
    cols = np.full((n, w), h, dtype=np.int32)
    vals = np.zeros((n, w), dtype=A.dtype)
    rows = np.repeat(np.arange(n), row_nnz)
    offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)
    win_start = (rows // nl).astype(np.int64) * nl - h
    cols[rows, offs] = (A.indices - win_start).astype(np.int32)
    vals[rows, offs] = A.data
    hrows = 0
    if h > 0 and A.nnz:
        start = (rows // nl).astype(np.int64) * nl
        is_halo = (A.indices < start) | (A.indices >= start + nl)
        if is_halo.any():
            l = (rows[is_halo] % nl).astype(np.int64)
            hrows = int(np.minimum(l, nl - 1 - l).max()) + 1
    return HaloPack(cols, vals, A.diagonal(), h, hrows, perm)


def _cpu_tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a`` (a tensor, or a numpy array, bf16 too), bit for
    bit."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return tensor_from_numpy(a)


def _layout(cols, vals, shift: int):
    """The sliced-ELL layout of ELL rows ``cols``/``vals`` (window-relative
    columns moved by ``shift``); slots of value 0, the padding, are not
    stored."""
    import scipy.sparse as sp

    m, w = cols.shape
    keep = vals != 0
    rows = np.repeat(np.arange(m), w).reshape(m, w)[keep]
    c = cols[keep].astype(np.int64) + shift
    ncols = int(c.max()) + 1 if c.size else 1
    A = sp.csr_matrix((vals[keep], (rows, c)), shape=(m, max(ncols, 1)))
    return WE.from_csr(A, vals.dtype)


class HaloELLOperator(LinearOperator):
    """Row-partitioned sparse operator with a one-hop halo exchange (the
    JAX package's ``HaloELLOperator``). This rank holds rows ``[r nl, (r +
    1) nl)`` of an ``n``-row matrix (``nl = n / P``), its columns relative
    to the window ``[r nl - h, (r + 1) nl + h)``: its left neighbour's last
    ``h`` rows, its own, its right neighbour's first ``h``. A product
    exchanges those ``[h, k]`` segments (``2 h k`` elements sent a rank,
    no wraparound: the edge ranks read zeros) and runs the sliced-ELL
    kernel of ``csrc/windowed_ell.cu`` on two layouts: the interior rows
    ``[hrows, nl - hrows)``, whose columns all lie in the rank's own rows,
    launched once the exchange is posted and before it is awaited; then the
    ``hrows`` boundary rows at each edge over the window. Each writes its
    row slice of one output block. Without a partition (``comm`` None) one
    layout covers every row, its columns moved from the zero-padded window
    onto the block itself (only padding slots, which the layout does not
    store, point into the pad).

    ``cols``/``vals``/``diag`` are this rank's rows of the JAX package's
    arrays (numpy, or tensors on the CPU); ``shape`` is the global ``(n,
    n)``. Values of any served type, f16 and bf16 too (a numpy bf16 array
    through the bits of its ``uint16`` view): scipy holds no half matrix,
    so the layouts of half values are built from their exact f32 values
    and hold the half type, the same values bit for bit. Hermitian
    operators (``rmatmat`` is ``matmat``), which is what ``eigsh``
    needs."""

    def __init__(self, cols, vals, diag, shape, halo: int,
                 comm: Optional[RowComm] = None, hrows: Optional[int] = None):
        super().__init__()
        cols = np.asarray(cols, np.int32)
        self.cols, self.vals = cols, vals
        vals = _cpu_tensor(vals)
        half = vals.dtype if vals.dtype in _HALF else None
        v = (vals.float() if half else vals).numpy()
        self.shape = tuple(int(s) for s in shape)
        self.halo = int(halo)
        self.hrows = 0 if hrows is None else int(hrows)
        self.comm = comm
        nl = cols.shape[0]
        self.nl = nl
        h, hr = self.halo, self.hrows
        self.register_buffer("diag", _cpu_tensor(diag).contiguous())
        self.sharded = comm is not None and comm.size > 1
        self.split = self.sharded and h > 0 and 0 < hr and 2 * hr < nl
        if not self.sharded or h == 0:
            parts = {"all": (_layout(cols, v, -h), nl)}
        elif self.split:
            parts = {"int": (_layout(cols[hr:nl - hr], v[hr:nl - hr], -h),
                             nl),
                     "top": (_layout(cols[:hr], v[:hr], 0), nl + 2 * h),
                     "bot": (_layout(cols[nl - hr:], v[nl - hr:], 0),
                             nl + 2 * h)}
        else:
            parts = {"all": (_layout(cols, v, 0), nl + 2 * h)}
        self._ncols = {}
        for key, (lay, ncols) in parts.items():
            for name in WE.SlicedELL._fields:
                t = _as_tensor(getattr(lay, name))
                if name == "vals" and half:
                    t = t.to(half)          # exact: the values were half
                self.register_buffer(f"{key}_{name}", t)
            self._ncols[key] = ncols

    @property
    def dtype(self) -> torch.dtype:
        return self.all_vals.dtype if "all" in self._ncols \
            else self.int_vals.dtype

    def _run(self, key, X, out):
        arrays = [getattr(self, f"{key}_{name}")
                  for name in WE.SlicedELL._fields]
        return WE.matmat(*arrays, X, self._ncols[key], out=out)

    def interior(self, x, Y):
        """The interior rows' product into ``Y``'s rows ``[hrows, nl -
        hrows)``: it reads ``x``, this rank's rows, alone."""
        hr = self.hrows
        self._run("int", x, Y[hr:self.nl - hr])

    def boundary(self, x, left, right, Y):
        """The boundary rows' product into ``Y``'s first and last
        ``hrows`` rows, over the window of ``left``, ``x`` and ``right``
        (all of ``Y`` when there is no interior split)."""
        xw = torch.cat([left, x, right])
        if not self.split:
            self._run("all", xw, Y)
            return
        hr = self.hrows
        self._run("top", xw, Y[:hr])
        self._run("bot", xw, Y[self.nl - hr:])

    def _local(self, x):
        Y = torch.empty((self.nl, x.shape[1]), dtype=x.dtype, device=x.device)
        if not self.sharded or self.halo == 0:
            return self._run("all", x, Y)
        pend = self.comm.halo_exchange_start(x, self.halo)
        if self.split:
            self.interior(x, Y)
        left, right = pend.wait()
        self.boundary(x, left, right, Y)
        return Y

    def matmat(self, X):
        # a half operator computes in a wider block's type (the mixed
        # entry points), as the unsharded ELLOperator does
        cdt = _compute_dtype(self.dtype, X)
        Y = _on_parts(lambda Z: self._local(Z.to(cdt).contiguous()), X, cdt)
        return Y.to(_result_dtype(self.dtype, X))

    def diagonal(self):
        return self.diag

    @staticmethod
    def from_pack(pk: HaloPack, comm: Optional[RowComm]) -> "HaloELLOperator":
        """This rank's operator from the global arrays of a pack."""
        n = pk.cols.shape[0]
        sl = slice(None) if comm is None else slice(comm.lo, comm.hi)
        return HaloELLOperator(pk.cols[sl], pk.vals[sl], pk.diag[sl],
                               (n, n), pk.halo, comm=comm, hrows=pk.hrows)

    @staticmethod
    def from_scipy(A, mesh=None, try_rcm: bool = True, device: Any = None
                   ) -> Optional[Tuple["HaloELLOperator",
                                       Optional[np.ndarray]]]:
        """Pack a scipy sparse matrix for ``mesh``'s row partition (None:
        one rank) and keep this rank's rows, on the mesh's device. Returns
        ``(operator, perm-or-None)``, a non-None ``perm`` meaning the
        operator acts on ``P A P^T``, or None where the JAX package's
        packing refuses the matrix (:func:`pack`)."""
        nsh = 1 if mesh is None else mesh.size()
        pk = pack(A, nsh, try_rcm)
        if pk is None:
            return None
        comm = None
        if mesh is not None:
            comm = mesh_comm(mesh, A.shape[0], device)
            device = mesh_device(mesh, device)
        op = HaloELLOperator.from_pack(pk, comm)
        if device is not None:
            op = op.to(device)
        return op, pk.perm


# ---------------------------------------------------------------------------
# The other sharded operators
# ---------------------------------------------------------------------------

class ShardedStencil3D(LinearOperator):
    """A :class:`Stencil3DOperator` split over x-planes: ``nx / P`` planes
    a rank (row ``(i ny + j) nz + l``, ``i`` the slowest index). A product
    exchanges one plane with each neighbour (zeros at the domain's edges,
    the Dirichlet ghosts) and runs the stencil kernel of
    ``csrc/stencil3d.cu`` on the window of ``nx / P + 2`` planes, keeping
    the middle ones."""

    def __init__(self, op: Stencil3DOperator, comm: RowComm):
        super().__init__()
        if op.nx % comm.size:
            raise ValueError(f"nx={op.nx} does not split over {comm.size} "
                             "ranks")
        self.op, self.comm = op, comm
        self.planes = op.nx // comm.size
        self.plane = op.ny * op.nz
        self.shape, self.dtype = op.shape, op.dtype

    def _local(self, x):
        o, pl = self.op, self.plane
        left, right = halo_exchange(x, pl, self.comm)
        xw = torch.cat([left, x, right])
        Y = ST.matmat(xw, self.planes + 2, o.ny, o.nz, o.scale)
        return Y[pl:pl + x.shape[0]]

    def matmat(self, X):
        return _on_parts(lambda Z: self._local(_kernel_block(Z, self.dtype)
                                               .contiguous()), X, self.dtype)

    def diagonal(self):
        return torch.full((self.comm.nl,), 6.0 * self.op.scale,
                          dtype=self.dtype, device=self.op.device)


class ShardedBanded(LinearOperator):
    """A :class:`BandedOperator` on this rank's rows: a product exchanges
    ``max |offset|`` rows with each neighbour and runs the DIA kernel of
    ``csrc/dia.cu`` on the window, whose rows outside this rank's hold
    zero diagonals, keeping the middle rows. The values (and the diagonal)
    keep the operator's type; the block's type is chosen as the unsharded
    operator chooses it (a half operator under a wider real block: the
    mixed entry points), so each row's arithmetic is the unsharded
    product's."""

    def __init__(self, op: BandedOperator, comm: RowComm):
        super().__init__()
        self.comm = comm
        self.hb = max((abs(o) for o in op.offsets), default=0)
        nl, hb = comm.nl, self.hb
        vw = op.vals.new_zeros((op.vals.shape[0], nl + 2 * hb))
        vw[:, hb:hb + nl] = op.vals[:, comm.lo:comm.hi]
        self.register_buffer("vals", vw)
        self.register_buffer("offs", op.offs.clone())
        self.register_buffer("diag", comm.rows(op.diagonal()).clone())
        self.shape = op.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def _local(self, x):
        hb = self.hb
        left, right = halo_exchange(x, hb, self.comm)
        xw = torch.cat([left, x, right])
        return DK.matmat(self.vals, self.offs, xw)[hb:hb + x.shape[0]]

    def matmat(self, X):
        cdt = _compute_dtype(self.dtype, X)
        Y = _on_parts(lambda Z: self._local(_kernel_block(Z, cdt)
                                            .contiguous()), X, cdt)
        return Y.to(_result_dtype(self.dtype, X))

    def diagonal(self):
        return self.diag


class GatheredOperator(LinearOperator):
    """Any operator under a row partition: a product all-gathers the block
    and applies ``op`` to it, ``op`` giving this rank's rows (``rows``
    True) or every row, of which this rank keeps its own. ``diag`` is
    this rank's part of the diagonal (or None)."""

    def __init__(self, op: LinearOperator, comm: RowComm, shape,
                 rows: bool = False, diag=None):
        super().__init__()
        self.op, self.comm, self.rows = op, comm, rows
        self.shape = tuple(shape)
        self.register_buffer("diag", None if diag is None
                             else _as_tensor(diag).clone())

    @property
    def dtype(self) -> torch.dtype:
        return self.op.dtype

    def matmat(self, X):
        Y = self.op.matmat(self.comm.all_gather_rows(X))
        return Y if self.rows else self.comm.rows(Y)

    def diagonal(self):
        return self.diag

    @staticmethod
    def from_scipy(A, comm: RowComm) -> "GatheredOperator":
        """This rank's rows of a scipy matrix, the format chosen by
        :func:`aslinearoperator` for the whole matrix (dense up to 8192
        rows, else the sliced-ELL layout)."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        rows = A[comm.lo:comm.hi]
        op = (DenseOperator(rows.toarray()) if densified(A)
              else ELLOperator.from_scipy(rows))
        return GatheredOperator(op, comm, A.shape, rows=True,
                                diag=comm.rows(A.diagonal()))


def shard_operator(op: LinearOperator, comm: RowComm) -> LinearOperator:
    """``op`` (on the solve's device) as an operator on this rank's rows:
    the stencil split over x-planes when ``nx`` divides by the ranks, the
    banded layout with its halo when every rank holds at least ``max
    |offset|`` rows, the Jacobi and diagonal operators on their rows, a
    :class:`HaloELLOperator` as it is, a cast around the sharded operator,
    and anything else through :class:`GatheredOperator`; of any served
    type, f16 and bf16 included (each form computes as its unsharded
    operator does)."""
    if isinstance(op, (HaloELLOperator, ShardedStencil3D, ShardedBanded,
                       GatheredOperator)):
        return op
    if isinstance(op, CastOperator):
        return CastOperator(shard_operator(op.op, comm), op.dtype)
    if isinstance(op, Stencil3DOperator) and op.nx % comm.size == 0:
        return ShardedStencil3D(op, comm)
    if isinstance(op, JacobiPrecond):
        return JacobiPrecond(comm.rows(op.d), eps=op.eps,
                             use_shifts=op.use_shifts)
    if isinstance(op, DiagonalOperator):
        return DiagonalOperator(comm.rows(op.d))
    if isinstance(op, BandedOperator):
        hb = max((abs(o) for o in op.offsets), default=0)
        smallest = min(comm.bounds(r)[1] - comm.bounds(r)[0]
                       for r in range(comm.size))
        if hb <= smallest:
            return ShardedBanded(op, comm)
    if isinstance(op, DenseOperator):
        return GatheredOperator(DenseOperator(comm.rows(op.A)), comm,
                                op.shape, rows=True,
                                diag=comm.rows(op.diagonal()))
    d = op.diagonal()
    return GatheredOperator(op, comm, op.shape,
                            diag=None if d is None else comm.rows(d))


# ---------------------------------------------------------------------------
# The multi-rank dry run
# ---------------------------------------------------------------------------

def _dryrun_rank(rank: int, n_ranks: int, backend: str, kind: str,
                 store_path: str) -> None:
    """One spawned rank of :func:`dryrun_multichip`."""
    if kind == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, n_ranks)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=n_ranks, timeout=TIMEOUT)
    try:
        dryrun_multichip(n_ranks, backend=backend, device=kind)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, backend: Optional[str] = None,
                     device: Any = None) -> dict:
    """Row-shard the ``__graft_entry__.py`` dry run over ``n_ranks`` ranks
    and run its whole solve: the ``(8 P, 8, 8)`` 7-point stencil with
    Jacobi, GD_Olsen_plusK, k = 4 with hard locking, block 2, basis 24,
    eps 1e-6, at most 4000 matvecs, from the seed-0 normal start block;
    the same asserts (every eigenvalue within 1e-4 of the closed form,
    residuals under 1.2e-4). ``device`` is where the ranks run: the card
    when None (raising without one), or ``"cpu"``; ``backend`` the process
    group's (gloo when None: several ranks share one card over gloo, NCCL
    refusing two ranks on one device). Called inside a process group of
    ``n_ranks`` ranks it runs this rank's part; outside one it spawns the
    ranks (the ``spawn`` start method: CUDA cannot be forked), each with a
    ``FileStore`` rendezvous, and an exception in a rank raises here.
    Returns this rank's values, residual norms and matvecs (the spawning
    call returns an empty dict)."""
    from torch.distributed.device_mesh import init_device_mesh
    from .core.solver import solve_eigs
    from .params import Method, PrimmeParams, set_method

    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip runs on the card unless "
                           "device=\"cpu\"; torch.cuda.is_available() is "
                           "False")
    backend = backend or "gloo"
    if not dist.is_initialized():
        import tempfile
        import torch.multiprocessing as mp

        if kind == "cuda":
            # build the kernels once, before any rank loads them
            from .ops import build
            for name in ("stencil3d", "jacobi"):
                build.load(name)
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_dryrun_rank, args=(n_ranks, backend, kind,
                                         os.path.join(tmp, "store")),
                     nprocs=n_ranks, join=True)
        return {}
    if dist.get_world_size() != n_ranks:
        raise ValueError(f"dryrun_multichip({n_ranks}) inside a process "
                         f"group of {dist.get_world_size()} ranks")
    mesh = init_device_mesh(kind, (n_ranks,))
    dev = mesh_device(mesh)
    nx, ny, nz = 8 * n_ranks, 8, 8
    n = nx * ny * nz
    k = 4
    comm = RowComm(mesh.get_group(), n, dev)
    A = shard_operator(Stencil3DOperator(nx, ny, nz, dtype=torch.float32,
                                         device=dev), comm)
    K = JacobiPrecond(A.diagonal())
    p = PrimmeParams(n=n, num_evals=k, eps=1e-6, max_basis_size=24,
                     max_block_size=2, max_matvecs=4000, locking=1)
    p = set_method(Method.GD_Olsen_plusK, p, has_precond=True)
    v0 = comm.rows(torch.as_tensor(
        np.random.default_rng(0).normal(size=(n, 2)), dtype=torch.float32))
    res = solve_eigs(A, p, K=K, v0=v0.to(dev), dtype=torch.float32,
                     device=dev, comm=comm)
    ev = np.sort(res.evals.cpu().numpy())
    resn = res.resnorms.cpu().numpy()

    def ax(N):
        return 2 - 2 * np.cos(np.pi * np.arange(1, N + 1) / (N + 1))
    lam = np.sort((ax(nx)[:4, None, None] + ax(ny)[None, :4, None]
                   + ax(nz)[None, None, :4]).ravel())[:k]
    err = np.abs(ev - lam).max()
    assert np.all(np.isfinite(ev)), ev
    assert err < 1e-4, (ev, lam)
    assert resn.max() < 1e-5 * 12.0, resn
    if comm.rank == 0:
        print(f"dryrun_multichip({n_ranks}): evals={ev} "
              f"matvecs={res.stats.num_matvecs} eval_err={err:.2e} "
              f"backend={comm.backend} device={dev}", flush=True)
    return {"evals": ev, "resnorms": resn,
            "matvecs": res.stats.num_matvecs}
