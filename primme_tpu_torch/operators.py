"""Operator layer: block-matvec linear operators (main-path subset).

PyTorch port of ``primme_tpu/operators.py``. An operator is an
``nn.Module`` holding its arrays as buffers, so ``.to(device)`` moves it,
with a ``matmat(X)`` on an ``[n, k]`` block. The port has the protocol,
:class:`WindowedELLOperator` (the sparse format the chooser picks for a
band-reducible matrix, applied by a hand-written CUDA kernel in f32 or
f64), :class:`CastOperator` (a working precision other than the
operator's) and the decision logic of :func:`rcm_banded`. Formats the
chooser may pick but the port does not have yet raise
``NotImplementedError`` naming the format; another format is never
substituted.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .core.linalg import real_dtype
from .ops import windowed_ell as WE


def _todo(fmt: str) -> NotImplementedError:
    return NotImplementedError(
        f"{fmt} is not ported to primme_tpu_torch yet (ROADMAP Queue A: "
        "the other operators and formats rcm_banded chooses)")


class LinearOperator(nn.Module):
    """Square operator with a block apply. Subclasses keep their arrays as
    buffers and set ``shape`` and ``dtype``."""

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
        return torch.device("cpu")


class WindowedELLOperator(LinearOperator):
    """Band-reducible sparse operator in the windowed-slot ELL format of
    ``ops/windowed_ell.py``; ``matmat`` launches the hand-written Hopper
    kernel on CUDA tensors. Symmetric matrices only (``rmatmat`` aliases
    ``matmat``). The operator's dtype is that of ``vals``: f64 values (an
    f64 matrix) run the kernel's native FP64 entry point, the port of the
    reference's f32x2 ``matmat_ds``; anything else is stored as f32."""

    def __init__(self, scal, offs, vals, meta):
        super().__init__()
        vals = np.asarray(vals)
        vdt = np.float64 if vals.dtype == np.float64 else np.float32
        # np.array copies: the buffers never alias (read-only) inputs
        self.register_buffer("scal", torch.from_numpy(np.array(scal, np.int32)))
        self.register_buffer("offs", torch.from_numpy(np.array(offs, np.int32)))
        self.register_buffer("vals", torch.from_numpy(np.array(vals, vdt)))
        self.meta = tuple(int(x) for x in meta)   # nrb, S, npad, n, pad, WB
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
        Y = WE.matmat(self.meta, self.scal, self.offs, self.vals,
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
    """Uniform preconditioner application; identity if ``K is None``.
    ``shifts`` is unused until a shifted preconditioner (the reference's
    ``JacobiPrecond.matmat_shifted``) is ported."""
    if K is None:
        return X
    return K.matmat(X)


def aslinearoperator(A: Any) -> LinearOperator:
    """Pass a port :class:`LinearOperator` through. The reference's other
    branches (dense arrays, scipy sparse outside :func:`rcm_banded`,
    scipy ``LinearOperator``) are not ported yet and raise."""
    if isinstance(A, LinearOperator):
        return A
    import scipy.sparse as sp

    if sp.issparse(A):
        nr, mc = A.shape
        if max(nr, mc) <= 8192 and nr * mc * A.dtype.itemsize <= (256 << 20):
            raise _todo("DenseOperator (small sparse input densified)")
        raise _todo("ELLOperator (general sparse input)")
    raise _todo(f"an operator for {type(A).__name__} input")


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
