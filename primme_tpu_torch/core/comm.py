"""The row communicator of a sharded solve: explicit SPMD over
``torch.distributed``.

The reference's parallel model is a 1-D row partition: each rank owns
``nLocal`` rows of every ``[n, k]`` block and a ``globalSumReal`` follows
every reduction over rows (``include/primme_eigs.h:188-198``). The JAX
package gets the same from GSPMD, which inserts a ``psum`` behind each
row-sharded Gram, dot and norm. PyTorch has no GSPMD, so the port writes
the sums out: a sharded solve installs a :class:`RowComm` (:func:`installed`)
and the few helpers that reduce over rows (``linalg.gram``,
:func:`global_sum`, :func:`col_dots`, :func:`col_norms`, :func:`global_max`,
:func:`all_finite`, the tall QR's R factor) sum over the ranks while it is
installed. Without one, every helper is the unsharded computation and adds
nothing to it.

Rows split into contiguous blocks of ``ceil(n / P)``, the last one
shorter, as GSPMD splits an uneven dimension. Every host decision of the
solver reads replicated values only: the sums come back bit for bit the
same on every rank, and the projected problem is solved on every rank from
the same summed matrices, so the ranks take the same branches.

A gloo group moves CUDA tensors through host copies (its point-to-point
calls take host memory); NCCL moves device tensors.

The type of each sum over ranks is the type the unsharded solve computes
that reduction in. A Gram of single-precision blocks (f32, complex64, a
half basis) is summed in f64 (``linalg.gram``); the dots and norms of f32
and f64 blocks in their type; those of a half block (f16, bf16: what a
half operator returns) in f32, as torch sums a half tensor, and rounded
once to the half type after the sum (:func:`col_dots`, :func:`dot`,
:func:`norm`, :func:`col_norms`). No sum over ranks runs in a half type.
The halo exchanges carry a block in its own type."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_ACTIVE: Optional["RowComm"] = None

# the elements this process has sent in halo exchanges, and the exchanges
# it has started (the tests and chip_smoke.py read them)
SENT_ELEMENTS = 0
EXCHANGES = 0


class RowComm:
    """One rank's view of an ``n``-row partition over a process ``group``:
    its rows ``[lo, hi)``, the device its blocks live on, and the counts of
    the sums it made (the reference's ``numGlobalSum`` and
    ``volumeGlobalSum``)."""

    def __init__(self, group, n: int, device: torch.device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        self.n = int(n)
        self.block = -(-self.n // self.size)
        self.lo, self.hi = self.bounds(self.rank)
        self.nl = self.hi - self.lo
        # gloo takes host tensors: a CUDA block goes through a host copy
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.num_global_sum = 0
        self.volume_global_sum = 0

    def bounds(self, rank: int):
        """Rows ``[lo, hi)`` of ``rank``."""
        lo = min(rank * self.block, self.n)
        return lo, min(lo + self.block, self.n)

    def rows(self, A):
        """This rank's rows of a global array or tensor."""
        return A[self.lo:self.hi]

    def with_rows(self, n: int) -> "RowComm":
        """The same group over another row count (``svds``' two stages)."""
        return RowComm(self.group, n, self.device)

    def _peer(self, rank: int) -> int:
        """The global rank of the group's ``rank``."""
        return dist.get_global_rank(self.group, rank)

    def _host(self, t):
        return _wait(t.cpu) if self.staged else t

    def _back(self, h, device):
        """``h.to(device)``: a staged block's copy back to the card."""
        return _wait(h.to, device) if self.staged else h.to(device)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``t`` reduced over the ranks (a new tensor on ``t``'s device),
        counted as one sum of ``t.numel()`` scalars."""
        h = self._host(t).clone().contiguous()
        dist.all_reduce(h, op=op, group=self.group)
        self.num_global_sum += 1
        self.volume_global_sum += t.numel()
        return self._back(h, t.device)

    def all_gather_rows(self, X: torch.Tensor) -> torch.Tensor:
        """The global ``[n, ...]`` block from every rank's rows."""
        pad = self.block - X.shape[0]
        h = self._host(X).contiguous()
        if pad:
            h = torch.cat([h, h.new_zeros((pad,) + tuple(h.shape[1:]))])
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.group)
        return self._back(torch.cat(parts)[:self.n], X.device)

    def broadcast_int(self, value: int, src: int = 0) -> int:
        """Rank ``src``'s integer on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        if self.backend == "nccl":
            t = _wait(t.to, self.device)
        dist.broadcast(t, self._peer(src), group=self.group)
        return _wait(int, t) if self.backend == "nccl" else int(t.item())

    def halo_exchange_start(self, X: torch.Tensor, h: int):
        """Post the exchange of ``h`` boundary rows with the two
        neighbours, no wraparound: this rank's first ``h`` rows go to the
        rank before, its last ``h`` to the rank after. Returns a handle
        whose ``wait()`` gives ``(left, right)``, the ``[h, k]`` rows of
        the neighbours (zeros at the partition's edges)."""
        global SENT_ELEMENTS, EXCHANGES
        shape = (h,) + tuple(X.shape[1:])
        dev = "cpu" if self.staged else X.device
        pin = self.staged and torch.cuda.is_available()
        left = torch.zeros(shape, dtype=X.dtype, device=dev, pin_memory=pin)
        right = torch.zeros(shape, dtype=X.dtype, device=dev, pin_memory=pin)
        ops = []
        prev = self.rank - 1 if self.rank > 0 else None
        nxt = self.rank + 1 if self.rank < self.size - 1 else None
        sends = []
        if h:
            if prev is not None:
                sends.append((X[:h], prev))
                ops.append(dist.P2POp(dist.irecv, left, self._peer(prev),
                                      self.group))
            if nxt is not None:
                sends.append((X[X.shape[0] - h:], nxt))
                ops.append(dist.P2POp(dist.irecv, right, self._peer(nxt),
                                      self.group))
        for seg, peer in sends:
            buf = seg.contiguous()
            if self.staged:
                buf = _wait(buf.to, "cpu")
            ops.append(dist.P2POp(dist.isend, buf, self._peer(peer),
                                  self.group))
            SENT_ELEMENTS += buf.numel()
        EXCHANGES += 1
        reqs = dist.batch_isend_irecv(ops) if ops else []
        return _Pending(reqs, left, right, X.device)


def _wait(fn, *args):
    """``fn(*args)``, a wait for the card, through
    :func:`~.linalg.host_read` (imported here: ``linalg`` imports this
    module)."""
    from .linalg import host_read
    return host_read(fn, *args)


class _Pending:
    def __init__(self, reqs, left, right, device):
        self.reqs, self.left, self.right = reqs, left, right
        self.device = device

    def wait(self):
        for r in self.reqs:
            r.wait()
        return (self.left.to(self.device, non_blocking=True),
                self.right.to(self.device, non_blocking=True))


def active() -> Optional[RowComm]:
    """The communicator of the running sharded solve, or None."""
    return _ACTIVE


@contextlib.contextmanager
def installed(comm: Optional[RowComm]):
    """Run the block with ``comm`` as the solve's communicator (None: the
    unsharded solve)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, comm
    try:
        yield comm
    finally:
        _ACTIVE = prev


def local_rows(n: int) -> int:
    """This rank's share of ``n`` global rows (``n`` unsharded)."""
    return n if _ACTIVE is None else _ACTIVE.nl


def global_rows(nl: int) -> int:
    """The global row count of blocks of ``nl`` local rows."""
    return nl if _ACTIVE is None else _ACTIVE.n


_HALF = (torch.float16, torch.bfloat16)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a sum over this rank's rows, summed over the ranks."""
    return t if _ACTIVE is None else _ACTIVE.all_reduce(t)


def _row_sum(P: torch.Tensor, dims) -> torch.Tensor:
    """The sum of ``P`` (a product of row-sharded blocks) over ``dims``
    and over the ranks: a half ``P`` summed in f32, as torch sums it
    unsharded, and rounded once to its type after the sum over ranks."""
    if _ACTIVE is None:
        return torch.sum(P, dim=dims)
    if P.dtype in _HALF:
        return global_sum(torch.sum(P, dim=dims, dtype=torch.float32)
                          ).to(P.dtype)
    return global_sum(torch.sum(P, dim=dims))


def global_max(t: torch.Tensor) -> torch.Tensor:
    """The largest of every rank's ``t`` (exact, so replicated)."""
    if _ACTIVE is None:
        return t
    return _ACTIVE.all_reduce(t, op=dist.ReduceOp.MAX)


def all_finite(X: torch.Tensor) -> torch.Tensor:
    """Whether every entry of the row-sharded ``X`` is finite, as a bool
    tensor."""
    fin = torch.isfinite(X).all()
    if _ACTIVE is None:
        return fin
    bad = _ACTIVE.all_reduce((~fin).to(torch.float64), op=dist.ReduceOp.MAX)
    return bad == 0


def col_dots(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Per-column ``x_j^H y_j`` of two row-sharded blocks (complex where
    they are)."""
    return _row_sum(X.conj() * Y, 0)


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x^H y`` over every entry of two row-sharded blocks (a scalar)."""
    return _row_sum(x.conj() * y, None)


def _norm_of(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # the square root of a summed square in f32 for a half x (as torch's
    # vector_norm of a half tensor), rounded once to x's real type
    return torch.sqrt(torch.clamp(s.real, min=0.0)).to(x.real.dtype)


def norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of every entry of a row-sharded block (a scalar)."""
    if _ACTIVE is None:
        return torch.linalg.vector_norm(x)
    xa = x.float() if x.dtype in _HALF else x
    return _norm_of(dot(xa, xa), x)


def col_norms(X: torch.Tensor) -> torch.Tensor:
    """Per-column 2-norms of a row-sharded block (real)."""
    if _ACTIVE is None:
        return torch.linalg.vector_norm(X, dim=0)
    Xa = X.float() if X.dtype in _HALF else X
    return _norm_of(col_dots(Xa, Xa), X)


def allgather_rows(X: torch.Tensor, comm: Optional[RowComm] = None
                   ) -> torch.Tensor:
    """The global block from every rank's rows (``X`` itself unsharded)."""
    comm = comm or _ACTIVE
    return X if comm is None else comm.all_gather_rows(X)


def halo_exchange(X: torch.Tensor, h: int,
                  comm: Optional[RowComm] = None):
    """``(left, right)``: the last ``h`` rows of the rank before and the
    first ``h`` of the rank after (zeros at the edges), for this rank's
    rows ``X``; one ``batch_isend_irecv`` with the two neighbours."""
    return (comm or _ACTIVE).halo_exchange_start(X, h).wait()


def rows_of(A, comm: Optional[RowComm] = None):
    """This rank's rows of a global array (all of it unsharded)."""
    comm = comm or _ACTIVE
    return A if comm is None else comm.rows(A)
