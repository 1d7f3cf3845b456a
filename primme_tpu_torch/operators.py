"""Operator layer: block-matvec linear operators (main-path subset).

PyTorch port of ``primme_tpu/operators.py``. An operator is an
``nn.Module`` holding its arrays as buffers, so ``.to(device)`` moves it,
with a ``matmat(X)`` on an ``[n, k]`` block; one that holds no array
(:class:`Stencil3DOperator`) states its device. The port has the protocol,
:class:`Stencil3DOperator` and :class:`JacobiPrecond` (``bench.py``'s
headline operator and preconditioner, each applied by a hand-written CUDA
kernel), :class:`WindowedELLOperator` (the sparse format the chooser picks
for a band-reducible matrix, applied by a hand-written CUDA kernel in f32
or f64), :class:`DenseOperator`, :class:`DiagonalOperator`,
:class:`CastOperator` (a working precision other than the operator's) and
the decision logic of :func:`rcm_banded`. Formats the chooser may pick but
the port does not have yet raise ``NotImplementedError`` naming the
format; another format is never substituted.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .core.linalg import real_dtype
from .ops import jacobi as JK
from .ops import stencil3d as ST
from .ops import windowed_ell as WE


def default_device(device: Any, what: str) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    when there is none: the port runs on the card unless the caller asks
    for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on the card unless asked otherwise, and "
                "torch.cuda.is_available() is False; pass device=\"cpu\" "
                "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _todo(fmt: str) -> NotImplementedError:
    return NotImplementedError(
        f"{fmt} is not ported to primme_tpu_torch yet (ROADMAP Queue A: "
        "the other operators and formats rcm_banded chooses)")


class LinearOperator(nn.Module):
    """Square operator with a block apply. Subclasses keep their arrays as
    buffers and set ``shape`` and ``dtype``; one that holds no array keeps
    an empty buffer on its device, which ``.to(device)`` moves."""

    shape: Tuple[int, int]
    dtype: torch.dtype

    def matmat(self, X: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def rmatmat(self, X: torch.Tensor) -> torch.Tensor:
        """Adjoint block apply (A^H X). Default: square Hermitian."""
        if self.shape[0] != self.shape[1]:
            raise NotImplementedError
        return self.matmat(X)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            return self.matmat(x[:, None])[:, 0]
        return self.matmat(x)

    def diagonal(self) -> Optional[torch.Tensor]:
        """Main diagonal if cheaply available (for Jacobi precond)."""
        return None

    @property
    def device(self) -> torch.device:
        for b in self.buffers():
            return b.device
        raise TypeError(f"{type(self).__name__} holds no array and states "
                        "no device")


def _as_tensor(a) -> torch.Tensor:
    """A tensor as it is; a numpy array (or what converts to one) copied
    into a CPU tensor of its dtype."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a))


def _kernel_block(X: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """X in ``dtype`` as the stencil and Jacobi kernels take it: its rows
    may lie apart (a column slice of the basis needs no copy), its columns
    must be adjacent."""
    X = X.to(dtype)
    if X.shape[1] > 1 and X.stride(1) != 1:
        X = X.contiguous()
    return X


class DenseOperator(LinearOperator):
    """Explicit (dense) matrix operator: one ``torch.matmul`` per apply
    (a plain product, as the reference leaves it to XLA; TF32 is off)."""

    def __init__(self, A):
        super().__init__()
        A = _as_tensor(A)
        if A.ndim != 2:
            raise ValueError("expected a 2-D operator")
        self.register_buffer("A", A)
        self.shape = tuple(A.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    def matmat(self, X):
        return self.A @ X.to(self.dtype)

    def rmatmat(self, X):
        return self.A.mH @ X.to(self.dtype)

    def diagonal(self):
        return torch.diagonal(self.A)


class DiagonalOperator(LinearOperator):
    """Diagonal matrix: an elementwise scale of each row of the block."""

    def __init__(self, d):
        super().__init__()
        d = _as_tensor(d)
        self.register_buffer("d", d)
        self.shape = (d.shape[0], d.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.d.dtype

    def matmat(self, X):
        return self.d[:, None] * X

    def rmatmat(self, X):
        return self.d.conj()[:, None] * X

    def diagonal(self):
        return self.d


class Stencil3DOperator(LinearOperator):
    """7-point 3-D Laplacian on an ``nx*ny*nz`` grid with Dirichlet edges,
    scaled by ``scale``: ``bench.py``'s headline operator. Rows are grid
    points in the reference's order, row ``(i*ny + j)*nz + l``. ``matmat``
    runs the hand-written kernel of ``csrc/stencil3d.cu`` on the card (the
    plain version on the CPU) in the operator's dtype and returns that
    dtype, as the reference does; ``rmatmat`` is the same product.

    The operator holds no array, so it states its device with an empty
    buffer: None means the card, and raises when there is none;
    ``device="cpu"`` runs on the CPU; ``.to(device)`` moves it."""

    def __init__(self, nx: int, ny: int, nz: int,
                 dtype: torch.dtype = torch.float32, scale: float = 1.0,
                 device: Any = None):
        super().__init__()
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.scale = float(scale)
        self.dtype = dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(f"a stencil of dtype {self.dtype} "
                                      "(f32 and f64 only)")
        n = self.nx * self.ny * self.nz
        self.shape = (n, n)
        self.register_buffer("_anchor", torch.empty(
            0, dtype=dtype, device=default_device(device, "Stencil3DOperator")),
            persistent=False)

    def matmat(self, X):
        return ST.matmat(_kernel_block(X, self.dtype), self.nx, self.ny,
                         self.nz, self.scale)

    def diagonal(self):
        return torch.full((self.shape[0],), 6.0 * self.scale,
                          dtype=self.dtype, device=self.device)


class JacobiPrecond(LinearOperator):
    """Shift-aware Jacobi preconditioner, ``X -> X / (diag(A) - sigma)``
    (the reference's ``JacobiPrecond``). ``matmat`` applies
    ``safe_inv(d) * X``, ``matmat_shifted`` divides column ``j`` by
    ``d - shifts[j]`` (or is ``matmat`` when ``use_shifts`` is False); a
    denominator under ``eps`` in magnitude becomes ``eps``. Both run the
    hand-written kernel of ``csrc/jacobi.cu`` on the card (the plain
    version on the CPU), each rounding as the reference writes it."""

    def __init__(self, diag, eps: float = 1e-10, use_shifts: bool = True):
        super().__init__()
        # contiguous, as the kernel takes it (a DenseOperator's diagonal is
        # a strided view)
        d = _as_tensor(diag).contiguous()
        self.register_buffer("d", d)
        self.eps = float(eps)
        self.use_shifts = bool(use_shifts)
        self.shape = (d.shape[0], d.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.d.dtype

    def matmat(self, X):
        return JK.unshifted(_kernel_block(X, self.dtype), self.d, self.eps)

    def matmat_shifted(self, X, shifts):
        """Apply with per-column shifts: ``X[:, j] / (d - shifts[j])``."""
        if not self.use_shifts:
            return self.matmat(X)
        return JK.shifted(_kernel_block(X, self.dtype), self.d,
                          shifts.to(device=self.d.device, dtype=self.dtype),
                          self.eps)


class WindowedELLOperator(LinearOperator):
    """Band-reducible sparse operator, chosen and packed in the
    windowed-slot ELL format of ``ops/windowed_ell.py`` and held as its
    compact warp-sliced layout (``WE.compact``: no padding slots);
    ``matmat`` launches the hand-written Hopper kernel on CUDA tensors.
    Symmetric matrices only (``rmatmat`` aliases ``matmat``). The
    operator's dtype is that of ``vals``: f64 values (an f64 matrix) run
    the kernel's native FP64 entry point, the port of the reference's
    f32x2 ``matmat_ds``; anything else is stored as f32. ``meta`` is the
    packed layout's, as the reference's operator has it."""

    def __init__(self, scal, offs, vals, meta):
        super().__init__()
        vals = np.asarray(vals)
        vdt = np.float64 if vals.dtype == np.float64 else np.float32
        self.meta = tuple(int(x) for x in meta)   # nrb, S, npad, n, pad, WB
        lay = WE.compact(scal, offs, vals.astype(vdt, copy=False), self.meta)
        for name in lay._fields:
            self.register_buffer(name, torch.from_numpy(getattr(lay, name)))
        n = self.meta[3]
        self.shape = (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @staticmethod
    def from_scipy(A) -> Optional["WindowedELLOperator"]:
        dt = (np.float64 if np.dtype(A.dtype) == np.dtype(np.float64)
              else np.float32)
        packed = WE.pack(A, dtype=dt)
        if packed is None:
            return None
        return WindowedELLOperator(
            packed.scal, packed.offs, packed.vals,
            (packed.nrb, packed.S, packed.npad, packed.n, packed.pad,
             packed.WB))

    def matmat(self, X):
        # the product runs in the operator's precision, whatever X's
        Y = WE.matmat(self.slice_ptr, self.rowlen, self.cols, self.vals,
                      X.to(self.dtype).contiguous())
        return Y.to(X.dtype)

    def diagonal(self):
        # the reference returns None here too (no Jacobi on this format)
        return None


class CastOperator(LinearOperator):
    """Run an operator at its own precision while the solver works in
    another (the reference's ``internalPrecision`` boundary: blocks are
    cast at the matvec mediation layer)."""

    def __init__(self, op: LinearOperator, dtype: torch.dtype):
        super().__init__()
        self.op = op
        self.dtype = dtype
        self.shape = op.shape

    def matmat(self, X):
        return self.op.matmat(X.to(self.op.dtype)).to(self.dtype)

    def rmatmat(self, X):
        return self.op.rmatmat(X.to(self.op.dtype)).to(self.dtype)

    def matmat_shifted(self, X, shifts):
        if hasattr(self.op, "matmat_shifted"):
            return self.op.matmat_shifted(
                X.to(self.op.dtype), shifts.to(real_dtype(self.op.dtype))
            ).to(self.dtype)
        return self.matmat(X)

    def diagonal(self):
        d = self.op.diagonal()
        return None if d is None else d.to(self.dtype)


def apply_precond(K: Optional[LinearOperator], X: torch.Tensor,
                  shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform preconditioner application; identity if ``K is None``. A
    preconditioner with ``matmat_shifted`` gets the per-column ``shifts``
    when they are given (the reference's mediation of
    ``applyPreconditioner_Sprimme``)."""
    if K is None:
        return X
    if shifts is not None and hasattr(K, "matmat_shifted"):
        return K.matmat_shifted(X, shifts)
    return K.matmat(X)


def aslinearoperator(A: Any) -> LinearOperator:
    """Coerce a port :class:`LinearOperator` (passed through), a numpy or
    torch 2-D array (a :class:`DenseOperator`) or a scipy sparse matrix of
    at most 8192 rows and columns and 256 MB dense (densified, as the
    reference does). The reference's other branches (a larger scipy sparse
    matrix becomes an ``ELLOperator``, a scipy ``LinearOperator`` a
    ``FunctionOperator``) are not ported yet and raise, naming themselves."""
    if isinstance(A, LinearOperator):
        return A
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    if sp.issparse(A):
        nr, mc = A.shape
        if max(nr, mc) <= 8192 and nr * mc * A.dtype.itemsize <= (256 << 20):
            return DenseOperator(A.toarray())
        raise _todo("ELLOperator (general sparse input)")
    if isinstance(A, spla.LinearOperator):
        raise _todo("FunctionOperator (scipy LinearOperator input)")
    return DenseOperator(A)


def _dia_ell_accepts(A, max_diags: int = 256, min_fill: float = 0.25,
                     min_coverage: float = 0.5) -> bool:
    """Acceptance test of the reference's ``dia_ell_hybrid``: would the
    DIA+ELL split be taken?"""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1] or A.nnz == 0:
        return False
    C = A.tocoo()
    offs_all, counts = np.unique(C.col - C.row, return_counts=True)
    good = counts / n >= min_fill
    good |= offs_all == 0
    if good.sum() == 0 or good.sum() > max_diags:
        return False
    return counts[good].sum() >= min_coverage * A.nnz


def rcm_banded(A, max_diags: int = 256, fill_factor: float = 32.0,
               mem_cap_bytes: int = 1 << 30):
    """The reference's sparse format chooser (``operators.rcm_banded``):
    the same decisions in the same order on the natural and the reverse
    Cuthill-McKee ordering. Returns ``(operator, perm-or-None)`` or None;
    a non-None perm means the operator acts on ``P A P^T``. Raises
    ``NotImplementedError`` where the reference would choose a format the
    port does not have yet."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = sp.csr_matrix(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        return None

    def _accept(M):
        C = M.tocoo()
        offs = np.unique(C.col - C.row)
        return (len(offs) <= max_diags
                and len(offs) * n <= fill_factor * max(M.nnz, 1)
                and len(offs) * n * M.dtype.itemsize <= mem_cap_bytes)

    if _accept(A):
        raise _todo("BandedOperator (DIA layout)")
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    Ap = A[perm][:, perm]
    if _accept(Ap):
        raise _todo("BandedOperator (DIA layout after RCM)")
    if _dia_ell_accepts(A, max_diags=max_diags) \
            or _dia_ell_accepts(Ap, max_diags=max_diags):
        raise _todo("SumOperator (DIA+ELL hybrid)")
    if A.dtype in (np.float32, np.float64) and n >= 4096:
        won = WindowedELLOperator.from_scipy(Ap)
        if won is not None:
            return won, perm
    Cp = Ap.tocoo()
    for b in (8, 4):
        nblk = len(np.unique(
            (Cp.row // b).astype(np.int64) * (-(-n // b)) + Cp.col // b))
        stored = nblk * b * b
        if stored <= 6.0 * A.nnz and stored * A.dtype.itemsize <= mem_cap_bytes:
            raise _todo("BlockELLOperator")
    return None
