"""Operator layer: block-matvec linear operators.

PyTorch port of ``primme_tpu/operators.py``. An operator is an
``nn.Module`` holding its arrays as buffers, so ``.to(device)`` moves it,
with a ``matmat(X)`` on an ``[n, k]`` block and ``to_dense()``. As
PyTorch's modules, an operator built from arrays (the constructors,
``from_scipy``, ``ELLOperator.from_coo``) lies on the CPU, or where its
tensors lie, until ``.to(device)``; one that holds no array
(:class:`Stencil3DOperator`, :class:`FunctionOperator`) states its device,
the card unless asked. ``solve_eigs`` runs on the card unless asked and
raises on an operator that lives elsewhere.
Operators and their products:

* :class:`Stencil3DOperator` and :class:`JacobiPrecond` (``bench.py``'s
  headline operator and preconditioner): ``csrc/stencil3d.cu`` and
  ``csrc/jacobi.cu``;
* the sparse formats the chooser (:func:`rcm_banded`,
  :func:`aslinearoperator`) picks, each in the same case as the reference:
  :class:`BandedOperator` (DIA, ``csrc/dia.cu``), the DIA+ELL hybrid
  :class:`SumOperator` (:func:`dia_ell_hybrid`), :class:`WindowedELLOperator`
  and :class:`ELLOperator` (the sliced-ELL layout of ``csrc/windowed_ell.cu``,
  f32 or f64), :class:`BlockELLOperator` (a panel gather and one batched
  product in plain PyTorch, as the reference leaves it to XLA);
* :class:`DenseOperator`, :class:`DiagonalOperator`,
  :class:`FunctionOperator` (a scipy ``LinearOperator`` applied on the
  host) and :class:`CastOperator` (a working precision other than the
  operator's);
* :class:`ChebyshevPrecond`, a polynomial preconditioner over any of
  them (``degree - 1`` products a block).

The sparse formats hold f32, f64, f16, bf16, complex64 or complex128
values (the windowed-slot ELL layout f32 and f64 only, as the reference's
chooser decides); other types raise ``NotImplementedError`` naming the
format. A half operator (f16, bf16) runs its kernel's half entry point on
a half block: under an f32 solve :class:`CastOperator` casts the blocks to
it (the reference's ``internalPrecision`` boundary). Given a wider real
block (a half basis hands it f32 blocks) it computes as the reference's
products promote (:func:`_compute_dtype`): the stencil casts the block to
its type; Jacobi, DIA and the sliced ELL run their kernels' mixed entry
points, which read the half values and compute in the block's type; the
plain-PyTorch formats cast their half values once and keep the cast
(:func:`_promoted`). A real operator applied
to a complex block multiplies both its parts: the block goes through the
real product as the ``[n, 2k]`` real block of its real and imaginary parts
(:func:`_on_parts`), one launch for both; a half operator takes no complex
block (there is no complex half type, and the reference's cast drops the
imaginary part: ROADMAP Queue C6).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .core.linalg import real_dtype, scope
from .ops import dia as DK
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

    def to_dense(self) -> torch.Tensor:
        """The ``[m, n]`` matrix: ``matmat`` of the ``n x n`` identity on
        the operator's device, in its dtype, so on the card through the
        operator's own kernel."""
        n = self.shape[1]
        return self.matmat(torch.eye(n, dtype=self.dtype, device=self.device))

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


_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_HALF = (torch.float16, torch.bfloat16)


def _no_complex_half(dtype: torch.dtype, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} on a {dtype} operator is not served by primme_tpu_torch: "
        "there is no complex half type, and the JAX package's cast of the "
        "block to the operator's type drops its imaginary part (ROADMAP "
        "Queue C6)")


def _on_parts(product: Callable, X: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``product(X)`` for an operator of type ``dtype``; where the operator
    is real and X complex, the product of both of X's parts: X in the
    complex type of ``dtype``'s precision, seen as the ``[n, 2k]`` real
    block of its real and imaginary parts (``torch.view_as_real``: no copy
    where its columns are adjacent, rows as far apart as X's), goes through
    ``product`` once and comes back complex. The reference's products
    promote so (``jnp`` einsums and shifts of a complex block)."""
    if not X.is_complex() or dtype.is_complex:
        return product(X)
    if dtype in _HALF:
        raise _no_complex_half(dtype, "a complex block")
    Xc = X.to(_COMPLEX[dtype]).resolve_conj()
    n, k = Xc.shape
    if k > 1 and Xc.stride(1) != 1:
        Xc = Xc.contiguous()
    Y = product(torch.view_as_real(Xc).reshape(n, 2 * k))
    return torch.view_as_complex(Y.contiguous().reshape(Y.shape[0], k, 2))


def _compute_dtype(op_dtype: torch.dtype, *blocks: torch.Tensor
                   ) -> torch.dtype:
    """The type a product of an operator of type ``op_dtype`` computes in:
    its own, except that a half operator given wider real blocks (a half
    basis hands it f32 ones) computes in their promoted type from its half
    values, as the reference's ``jnp`` products promote (its stencil alone
    casts the block to its type). The kernels take the half values as they
    are (their mixed entry points); nothing is cast a product."""
    out = op_dtype
    if op_dtype in _HALF:
        for b in blocks:
            if not b.is_complex():
                out = torch.promote_types(out, b.dtype)
    return out


def _promoted(module: nn.Module, name: str, dtype: torch.dtype
              ) -> torch.Tensor:
    """Buffer ``name`` of ``module`` in ``dtype``, cast once and kept while
    the buffer is the same tensor (a ``.to(device)`` replaces it): the
    plain-PyTorch half formats' values under a wider block."""
    t = getattr(module, name)
    if t.dtype == dtype:
        return t
    cache = module.__dict__.setdefault("_promoted_cache", {})
    hit = cache.get((name, dtype))
    if hit is None or hit[0] is not t:
        hit = cache[(name, dtype)] = (t, t.to(dtype))
    return hit[1]


def _kernel_block(X: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """X in ``dtype`` as the stencil, Jacobi and DIA kernels take it: its rows
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

    def _product(self, X, adjoint):
        cdt = _compute_dtype(self.dtype, X)
        A = _promoted(self, "A", cdt)               # cast once, if at all
        if adjoint:
            A = A.mH
        return _on_parts(lambda Z: A @ Z.to(cdt), X, cdt)

    def matmat(self, X):
        return self._product(X, False)

    def rmatmat(self, X):
        return self._product(X, True)

    def diagonal(self):
        return torch.diagonal(self.A)

    def to_dense(self):
        return self.A


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
    plain version on the CPU) in the operator's dtype (f32, f64, f16 or
    bf16; a complex64 or complex128 one on its real type's kernel, both
    parts of the block at once, the stencil's coefficients being real) and
    returns that dtype, as the reference does; ``rmatmat`` is the same
    product.

    The operator holds no array, so it states its device with an empty
    buffer: None means the card, and raises when there is none;
    ``device="cpu"`` runs on the CPU; ``.to(device)`` moves it."""

    def __init__(self, nx: int, ny: int, nz: int,
                 dtype: torch.dtype = torch.float32, scale: float = 1.0,
                 device: Any = None):
        super().__init__()
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)
        self.scale = float(scale)
        self.dtype = _value_dtype(dtype, "Stencil3DOperator")
        n = self.nx * self.ny * self.nz
        self.shape = (n, n)
        self.register_buffer("_anchor", torch.empty(
            0, dtype=self.dtype,
            device=default_device(device, "Stencil3DOperator")),
            persistent=False)

    def matmat(self, X):
        kdt = real_dtype(self.dtype)
        if self.dtype.is_complex:
            X = X.to(self.dtype)
        return _on_parts(
            lambda Z: ST.matmat(_kernel_block(Z, kdt), self.nx, self.ny,
                                self.nz, self.scale), X, kdt)

    def diagonal(self):
        return torch.full((self.shape[0],), 6.0 * self.scale,
                          dtype=self.dtype, device=self.device)


class JacobiPrecond(LinearOperator):
    """Shift-aware Jacobi preconditioner, ``X -> X / (diag(A) - sigma)``
    (the reference's ``JacobiPrecond``), in the diagonal's type (a half
    one on a half block, the shifts rounded to it as :class:`CastOperator`
    hands them over; given a wider real block and shifts, as a half basis
    does, in the block's type from the half diagonal, the kernel's mixed
    entry points). ``matmat`` applies
    ``safe_inv(d) * X``, ``matmat_shifted`` divides column ``j`` by
    ``d - shifts[j]`` (or is ``matmat`` when ``use_shifts`` is False); a
    denominator under ``eps`` in magnitude becomes ``eps``. Both run the
    hand-written kernel of ``csrc/jacobi.cu`` on the card (the plain
    version on the CPU), each rounding as the reference writes it. The
    diagonal is real (f32, f64, f16, bf16) or complex (complex64,
    complex128, e.g. a
    complex Hermitian matrix's, real in value); a real diagonal given
    complex shifts (the Ritz values of ``eigs``) divides by the complex
    ``d - shifts[j]``, as the reference promotes them."""

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
        if self.dtype.is_complex:
            return JK.unshifted(_kernel_block(X, self.dtype), self.d,
                                self.eps)
        # a half d under a wider block: the mixed entry point (the
        # reference's safe_inv(d) in the half type, times X in X's type)
        cdt = _compute_dtype(self.dtype, X)
        return _on_parts(
            lambda Z: JK.unshifted(_kernel_block(Z, cdt), self.d, self.eps),
            X, cdt)

    def matmat_shifted(self, X, shifts):
        """Apply with per-column shifts: ``X[:, j] / (d - shifts[j])``. A
        real diagonal divides a complex X's two parts by the real ``d -
        shifts[j]`` where the shifts are real, and X by the complex one
        where they are complex."""
        if not self.use_shifts:
            return self.matmat(X)
        if self.dtype in _HALF and shifts.is_complex():
            raise _no_complex_half(self.dtype, "complex shifts")
        if self.dtype.is_complex or shifts.is_complex():
            cdt = _COMPLEX.get(self.dtype, self.dtype)
            return JK.shifted(_kernel_block(X, cdt), self.d.to(cdt),
                              shifts.to(device=self.d.device, dtype=cdt),
                              self.eps)
        cdt = _compute_dtype(self.dtype, X, shifts)
        sh = shifts.to(device=self.d.device, dtype=cdt)
        if X.is_complex():
            sh = sh.repeat_interleave(2)
        return _on_parts(
            lambda Z: JK.shifted(_kernel_block(Z, cdt), self.d, sh, self.eps),
            X, cdt)


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
        """Pack a scipy matrix (None where it does not pack): on the CPU
        until ``.to(device)``."""
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
        Y = _on_parts(
            lambda Z: WE.matmat(self.slice_ptr, self.rowlen, self.cols,
                                self.vals, Z.to(self.dtype).contiguous()),
            X, self.dtype)
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
        if dtype.is_complex != op.dtype.is_complex:
            # the reference's cast of the block to the operator's type
            # drops a complex block's imaginary part (its eigsh on a real
            # matrix with dtype=complex64 does not converge): refused
            raise NotImplementedError(
                f"a working dtype of {dtype} over an operator of dtype "
                f"{op.dtype} is not served by primme_tpu_torch (the real and "
                "the complex types do not mix at the operator boundary: the "
                "JAX package's cast drops the imaginary part, ROADMAP Queue "
                "C6)")
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


class ChebyshevPrecond(LinearOperator):
    """Polynomial (Chebyshev-iteration) preconditioner, ``z ~= (A - sigma
    I)^{-1} r`` with the error polynomial equioscillating on ``[a, b]``,
    the interval enclosing the unwanted spectrum of ``A - sigma I`` (the
    reference's ``ChebyshevPrecond``; requires ``0 < a < b``, the wanted
    eigenvalues below ``a``). ``matmat`` is the classic three-term
    recurrence (Saad, alg. 12.1) as a host loop of ``degree - 1`` steps,
    each one block product with ``A``: on the card, ``A``'s own kernel.
    The recurrence's scalars are computed on the host in the operator's
    real precision (a half one too), as the reference computes them."""

    def __init__(self, A, interval, degree: int = 10, sigma: float = 0.0):
        super().__init__()
        self.A = A if isinstance(A, LinearOperator) else aslinearoperator(A)
        rdt = real_dtype(self.A.dtype)
        a, b = interval
        # host scalars in the real precision, each operation rounded to it
        # (0-d CPU tensors: numpy holds no bf16)
        self._r = lambda v: torch.tensor(v, dtype=rdt)
        self.a, self.b, self.sigma = (self._r(v) for v in (a, b, sigma))
        self.degree = int(degree)
        self.shape = self.A.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @classmethod
    def from_operator(cls, A, degree: int = 10, lower_frac: float = 0.05,
                      sigma: float = 0.0, power_iters: int = 20,
                      seed: int = 0) -> "ChebyshevPrecond":
        """Build with the interval estimated by a short power iteration on
        ``A`` from a normal start drawn by a ``torch.Generator`` seeded
        with ``seed``: ``b`` its last norm growth times 1.05, ``a =
        lower_frac * b`` (the wanted eigenvalues must lie below ``a``)."""
        from .core.linalg import rand_block

        Aop = A if isinstance(A, LinearOperator) else aslinearoperator(A)
        rdt = real_dtype(Aop.dtype)
        x = rand_block(torch.Generator().manual_seed(int(seed)),
                       Aop.shape[0], 1, Aop.dtype, Aop.device)
        lam = torch.ones((), dtype=rdt, device=x.device)
        tiny = torch.finfo(rdt).tiny
        for _ in range(power_iters):
            y = Aop.matmat(x)
            lam = torch.linalg.vector_norm(y)
            x = y / torch.clamp(lam, min=tiny)
        b = 1.05 * float(lam)
        return cls(Aop, (lower_frac * b, b), degree=degree, sigma=sigma)

    def matmat(self, X):
        r = self._r
        theta = r(0.5) * (self.b + self.a)
        delta = r(0.5) * (self.b - self.a)
        sig1 = theta / delta
        sh = float(self.sigma)
        z = X / float(theta)
        d = z
        rho = r(1.0) / sig1
        for _ in range(self.degree - 1):
            res = X - (self.A.matmat(z) - sh * z)
            rho_n = r(1.0) / (r(2.0) * sig1 - rho)
            d = float(rho_n * rho) * d + float(r(2.0) * rho_n / delta) * res
            z = z + d
            rho = rho_n
        return z


def apply_precond(K: Optional[LinearOperator], X: torch.Tensor,
                  shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform preconditioner application; identity if ``K is None``. A
    preconditioner with ``matmat_shifted`` gets the per-column ``shifts``
    when they are given (the reference's mediation of
    ``applyPreconditioner_Sprimme``)."""
    if K is None:
        return X
    with scope("pt_precond"):
        if shifts is not None and hasattr(K, "matmat_shifted"):
            return K.matmat_shifted(X, shifts)
        return K.matmat(X)


_SERVED = (torch.float32, torch.float64, *_HALF, torch.complex64,
           torch.complex128)


def _value_dtype(dtype, fmt: str) -> torch.dtype:
    """The torch type an operator stores, from a numpy, torch or named
    dtype: f32, f64, f16, bf16, complex64 or complex128 as given; other
    types are not served."""
    name = str(dtype).replace("torch.", "")
    served = getattr(torch, name, None)
    if served not in _SERVED:
        raise NotImplementedError(
            f"a {fmt} of dtype {name} is not ported to primme_tpu_torch "
            "(f32, f64, f16, bf16, complex64 and complex128 only)")
    return served


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type of a torch dtype that numpy holds (not bf16)."""
    return np.dtype(str(dtype).replace("torch.", ""))


def _result_dtype(op_dtype: torch.dtype, X: torch.Tensor) -> torch.dtype:
    # the reference's jnp product promotes the operator's type with X's
    return torch.promote_types(op_dtype, X.dtype)


class BandedOperator(LinearOperator):
    """DIA (diagonal) sparse operator: ``offsets`` (Python ints, in the
    stored order, which the sum keeps) and ``vals [B, n]`` row-indexed,
    ``vals[b, i] = A[i, i + offsets[b]]``. ``matmat`` and ``rmatmat`` run
    the hand-written kernel of ``csrc/dia.cu`` on the card and its plain
    version (the reference's loop) on the CPU, in the operator's type
    (f32, f64, f16, bf16, complex64 or complex128; a half operator given a
    wider real block in the block's type, its mixed entry points reading
    the half values); ``rmatmat`` is ``A^H``, the kernel conjugating the
    values."""

    def __init__(self, offsets, vals, shape=None):
        super().__init__()
        self.offsets = tuple(int(o) for o in offsets)
        vals = _as_tensor(vals)
        _value_dtype(vals.dtype, "BandedOperator")
        if vals.ndim != 2 or vals.shape[0] != len(self.offsets):
            raise ValueError(f"vals shape {tuple(vals.shape)} is not "
                             f"[{len(self.offsets)}, n]")
        self.register_buffer("vals", vals.contiguous())
        # the offsets as the kernel reads them
        self.register_buffer("offs", torch.tensor(self.offsets,
                                                  dtype=torch.int64))
        n = vals.shape[1]
        self.shape = tuple(shape) if shape is not None else (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def _product(self, X, adjoint):
        cdt = _compute_dtype(self.dtype, X)
        Y = _on_parts(lambda Z: DK.matmat(self.vals, self.offs,
                                          _kernel_block(Z, cdt),
                                          adjoint=adjoint), X, cdt)
        return Y.to(_result_dtype(self.dtype, X))

    def matmat(self, X):
        return self._product(X, False)

    def rmatmat(self, X):
        return self._product(X, True)

    def diagonal(self):
        if 0 in self.offsets:
            return self.vals[self.offsets.index(0)]
        return torch.zeros((self.shape[0],), dtype=self.dtype,
                           device=self.device)

    @staticmethod
    def from_scipy(A) -> "BandedOperator":
        """Build from a scipy matrix's diagonals: on the CPU until
        ``.to(device)``."""
        import scipy.sparse as sp

        _value_dtype(A.dtype, "BandedOperator")
        D = sp.dia_matrix(A)
        n = A.shape[0]
        offsets = [int(o) for o in D.offsets]
        # scipy stores data[b, j] = A[j - off, j] over its columns (which
        # may stop before n); vals[b, i] = A[i, i + off]
        data = np.zeros((len(offsets), max(n, D.data.shape[1])), D.dtype)
        data[:, :D.data.shape[1]] = D.data
        vals = np.zeros((len(offsets), n), dtype=D.dtype)
        for b, off in enumerate(offsets):
            if off >= 0:
                m = max(n - off, 0)
                vals[b, :m] = data[b, off:off + m]
            else:
                m = max(n + off, 0)
                vals[b, -off:] = data[b, :m]
        return BandedOperator(offsets, vals, shape=A.shape)


class ELLOperator(LinearOperator):
    """General sparse operator on the sliced-ELL layout
    (``ops/windowed_ell.py::SlicedELL``, built straight from CSR by
    ``from_csr``): ``matmat`` runs the hand-written kernel of
    ``csrc/windowed_ell.cu`` on the card and its plain version on the CPU,
    in the operator's f32, f64, f16, bf16, complex64 or complex128 (a half
    operator comes from :meth:`from_coo` or its layouts: scipy holds no
    half sparse matrix; its product sums in f32 and rounds once to the
    half type, as the reference's einsum). ``from_scipy``
    also lays out ``A^H`` (the reference's ``colsT``/``valsT``; its values
    conjugated when they are laid out, where the reference conjugates
    ``valsT`` at each apply), so ``rmatmat`` runs the same kernel, and
    takes the diagonal from the CSR. An ``m x n`` matrix keeps
    its shape: ``matmat`` takes ``[n, k]`` blocks to ``[m, k]`` on the
    ``A`` layout (m rows), ``rmatmat`` ``[m, k]`` to ``[n, k]`` on the
    ``A^T`` layout (n rows), and ``diagonal`` has the reference's length
    ``m`` (``A[i, i]``, 0 past column ``n``)."""

    _FIELDS = WE.SlicedELL._fields

    def __init__(self, lay, layT, diag):
        super().__init__()
        for name in self._FIELDS:
            self.register_buffer(name, _as_tensor(getattr(lay, name)))
            self.register_buffer(name + "_t", _as_tensor(getattr(layT, name)))
        self.register_buffer("diag", _as_tensor(diag))
        self.shape = (self.rowlen.shape[0], self.rowlen_t.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def _product(self, suffix, X, ncols):
        arrays = [getattr(self, name + suffix) for name in self._FIELDS]
        cdt = _compute_dtype(self.dtype, X)
        Y = _on_parts(lambda Z: WE.matmat(
            *arrays, Z.to(cdt).contiguous(), ncols), X, cdt)
        return Y.to(_result_dtype(self.dtype, X))

    def matmat(self, X):
        return self._product("", X, self.shape[1])

    def rmatmat(self, X):
        return self._product("_t", X, self.shape[0])

    def diagonal(self):
        return self.diag

    @staticmethod
    def from_scipy(A) -> "ELLOperator":
        """Lay out a scipy matrix and its adjoint: on the CPU until
        ``.to(device)``."""
        import scipy.sparse as sp

        dt = _value_dtype(A.dtype, "ELLOperator")
        if dt in _HALF:
            raise NotImplementedError(
                f"an ELLOperator of dtype {dt} from a scipy matrix: scipy "
                "holds no half sparse matrix (nor does the JAX package's "
                "from_scipy build one); ELLOperator.from_coo takes half "
                "values")
        dt = _numpy_dtype(dt)
        A = sp.csr_matrix(A)
        diag = np.zeros(A.shape[0], dt)
        d = A.diagonal()
        diag[:len(d)] = d
        return ELLOperator(WE.from_csr(A, dt),
                           WE.from_csr(A.conj().T.tocsr(), dt), diag)

    @staticmethod
    def from_coo(rows, cols, vals, shape) -> "ELLOperator":
        """Build from COO triplets (``rows``, ``cols``, ``vals``; repeated
        entries summed) of an ``m x n`` matrix, through
        :meth:`from_scipy`: on the CPU until ``.to(device)``. Half values
        (a numpy f16 array, or a torch f16 or bf16 tensor) give a half
        operator: the layouts are built from their exact f32 values (a
        repeated entry summed in f32) and hold the half type."""
        import scipy.sparse as sp

        half = None
        if isinstance(vals, torch.Tensor):
            half = vals.dtype if vals.dtype in _HALF else None
            vals = vals.detach().cpu()
            vals = (vals.float() if half else vals).numpy()
        vals = np.asarray(vals)
        if vals.dtype == np.float16:
            half, vals = torch.float16, vals.astype(np.float32)
        op = ELLOperator.from_scipy(
            sp.coo_matrix((vals, (np.asarray(rows), np.asarray(cols))),
                          shape=tuple(shape)))
        if half is not None:
            for name in ("vals", "vals_t", "diag"):
                setattr(op, name, getattr(op, name).to(half))
        return op


class BlockELLOperator(LinearOperator):
    """Block-ELLPACK (BSR-style) sparse operator: ``b x b`` dense blocks,
    ``w`` a block row. ``bcols [nb, w]`` holds block columns (padding
    points at block 0 with zero blocks), ``bvals [nb, w, b, b]``. The
    product gathers the ``b``-row panels of X and applies the blocks as one
    batched product (``einsum`` over ``[nb, w, b, b]`` by ``[nb, w, b,
    k]``; TF32 off), in plain PyTorch, as the reference leaves it to
    XLA's einsum. ``bcolsT``/``bvalsT`` lay out ``A^T`` as the
    reference's do, unconjugated: ``rmatmat`` conjugates the blocks."""

    def __init__(self, bcols, bvals, shape, bcolsT=None, bvalsT=None):
        super().__init__()
        bvals = _as_tensor(bvals)
        _value_dtype(bvals.dtype, "BlockELLOperator")
        self.register_buffer("bcols", _as_tensor(bcols).to(torch.int64))
        self.register_buffer("bvals", bvals)
        self.register_buffer("bcolsT", None if bcolsT is None
                             else _as_tensor(bcolsT).to(torch.int64))
        self.register_buffer("bvalsT", None if bvalsT is None
                             else _as_tensor(bvalsT))
        self.shape = tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.bvals.dtype

    @staticmethod
    def _product(bcols, bvals, X, nrows):
        nb, w, b, _ = bvals.shape
        k = X.shape[1]
        ncb = -(-X.shape[0] // b)           # column blocks of the matrix
        Xb = torch.nn.functional.pad(X, (0, 0, 0, ncb * b - X.shape[0]))
        G = Xb.reshape(ncb, b, k)[bcols]                  # [nb, w, b, k]
        Y = torch.einsum("iwab,iwbk->iak", bvals, G)      # batched blocks
        return Y.reshape(nb * b, k)[:nrows]

    def _blocks(self, bcols, vals_name, X, nrows, conj=False):
        cdt = _compute_dtype(self.dtype, X)
        bvals = _promoted(self, vals_name, cdt)     # cast once, if at all
        if conj:
            bvals = bvals.conj()
        return _on_parts(lambda Z: self._product(
            bcols, bvals, Z.to(cdt), nrows), X, cdt).to(
            _result_dtype(self.dtype, X))

    def matmat(self, X):
        return self._blocks(self.bcols, "bvals", X, self.shape[0])

    def rmatmat(self, X):
        if self.bcolsT is None:
            return super().rmatmat(X)
        return self._blocks(self.bcolsT, "bvalsT", X, self.shape[1],
                            conj=True)

    def diagonal(self):
        nb, w, b, _ = self.bvals.shape
        own = self.bcols == torch.arange(nb, device=self.bcols.device)[:, None]
        dblk = torch.diagonal(self.bvals, dim1=2, dim2=3)    # [nb, w, b]
        d = torch.where(own[:, :, None], dblk, 0).sum(dim=1)
        return d.reshape(nb * b)[:self.shape[0]]

    @staticmethod
    def _pack(A, b):
        import scipy.sparse as sp

        m, n = A.shape
        nbr, nbc = -(-m // b), -(-n // b)
        A = sp.csr_matrix(A).copy()
        A.resize(nbr * b, nbc * b)  # zero-pad to block multiples
        Absr = sp.bsr_matrix(A, blocksize=(b, b))
        Absr.sort_indices()
        rows_nnz = np.diff(Absr.indptr)
        w = max(int(rows_nnz.max()), 1)
        bcols = np.zeros((nbr, w), dtype=np.int32)
        bvals = np.zeros((nbr, w, b, b), dtype=Absr.dtype)
        rows = np.repeat(np.arange(nbr), rows_nnz)
        offs = np.arange(len(Absr.indices)) - np.repeat(
            Absr.indptr[:-1], rows_nnz)
        bcols[rows, offs] = Absr.indices
        bvals[rows, offs] = Absr.data
        return bcols, bvals

    @staticmethod
    def from_scipy(A, block_size: int = 8,
                   with_transpose: bool = False) -> "BlockELLOperator":
        """Pack a scipy matrix in ``block_size`` blocks: on the CPU until
        ``.to(device)``."""
        import scipy.sparse as sp

        _value_dtype(A.dtype, "BlockELLOperator")
        A = sp.csr_matrix(A)
        bcols, bvals = BlockELLOperator._pack(A, block_size)
        bcolsT = bvalsT = None
        if with_transpose or A.shape[0] != A.shape[1]:
            bcolsT, bvalsT = BlockELLOperator._pack(A.T.tocsr(), block_size)
        return BlockELLOperator(bcols, bvals, A.shape, bcolsT, bvalsT)


class FunctionOperator(LinearOperator):
    """A function ``f: [n, k] -> [m, k]`` on tensors (and ``rf`` for the
    adjoint) as an operator. It holds no array, so it states its device:
    None means the card, and raises when there is none; ``.to(device)``
    moves it."""

    def __init__(self, f: Callable, shape, dtype, rf: Optional[Callable] = None,
                 diag: Optional[torch.Tensor] = None, device: Any = None):
        super().__init__()
        self._f, self._rf = f, rf
        self.shape = tuple(shape)
        self.dtype = dtype
        self.register_buffer("_anchor", torch.empty(
            0, dtype=dtype,
            device=default_device(device, "FunctionOperator")),
            persistent=False)
        self.register_buffer("_diag", None if diag is None
                             else _as_tensor(diag))

    def matmat(self, X):
        return self._f(X)

    def rmatmat(self, X):
        if self._rf is not None:
            return self._rf(X)
        return super().rmatmat(X)

    def diagonal(self):
        return self._diag


def _on_host(fn, rows: int, dtype: np.dtype) -> Callable:
    """``fn`` on numpy blocks as a function on tensors: the block goes to
    the host, ``fn`` runs there and its result comes back to the block's
    device in ``dtype``, or its complex counterpart for a complex block
    and a real ``dtype`` (the reference's ``jax.pure_callback``)."""
    def call(X):
        Xh = X.detach().cpu().numpy()
        out = dtype
        if np.iscomplexobj(Xh) and dtype.kind != "c":
            out = np.result_type(dtype, np.complex64)
        Y = np.asarray(fn(Xh), dtype=out)
        return torch.from_numpy(
            np.ascontiguousarray(Y.reshape(rows, X.shape[1]))).to(X.device)
    return call


class SumOperator(LinearOperator):
    """``y = sum_i A_i x``: the DIA+ELL hybrid's banded part plus its
    scattered remainder (:func:`dia_ell_hybrid`)."""

    def __init__(self, ops):
        super().__init__()
        self.ops = nn.ModuleList(ops)
        self.shape = self.ops[0].shape

    @property
    def dtype(self) -> torch.dtype:
        return self.ops[0].dtype

    def matmat(self, X):
        y = self.ops[0].matmat(X)
        for op in self.ops[1:]:
            y = y + op.matmat(X)
        return y

    def rmatmat(self, X):
        y = self.ops[0].rmatmat(X)
        for op in self.ops[1:]:
            y = y + op.rmatmat(X)
        return y

    def diagonal(self):
        # a BandedOperator without a 0-offset stores a zero diagonal
        total = None
        for op in self.ops:
            d = op.diagonal()
            if d is None and isinstance(op, BandedOperator):
                continue
            if d is None:
                return None
            total = d if total is None else total + d
        return total


def densified(A) -> bool:
    """Whether :func:`aslinearoperator` makes the scipy sparse ``A`` a
    dense operator (the reference's rule: up to 8192 rows and columns and
    256 MB)."""
    nr, mc = A.shape
    return max(nr, mc) <= 8192 and nr * mc * A.dtype.itemsize <= (256 << 20)


def aslinearoperator(A: Any) -> LinearOperator:
    """Coerce a port :class:`LinearOperator` (passed through), a scipy
    sparse matrix (densified up to 8192 rows and columns and 256 MB, as
    the reference does, else an :class:`ELLOperator`), a scipy
    ``LinearOperator`` (a host :class:`FunctionOperator`) or a numpy or
    torch 2-D array (a :class:`DenseOperator`). What it builds lies on the
    CPU; ``eigsh`` moves it. A ``FunctionOperator`` applies the scipy
    operator on the host whatever its device."""
    if isinstance(A, LinearOperator):
        return A
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    if sp.issparse(A):
        if densified(A):
            return DenseOperator(A.toarray())
        return ELLOperator.from_scipy(A)
    if isinstance(A, spla.LinearOperator):
        tdt = _value_dtype(A.dtype, "FunctionOperator")
        dt = _numpy_dtype(tdt)
        return FunctionOperator(_on_host(A.matmat, A.shape[0], dt), A.shape,
                                tdt, rf=_on_host(A.rmatmat, A.shape[1], dt),
                                device="cpu")
    return DenseOperator(A)


def dia_ell_hybrid(A, max_diags: int = 256, min_fill: float = 0.25,
                   min_coverage: float = 0.5):
    """Split a sparse matrix into dense-ish diagonals (a
    :class:`BandedOperator`) plus a scattered remainder (an
    :class:`ELLOperator`): offsets whose occupancy is at least ``min_fill``
    (and the main diagonal) become the banded part; the split is taken when
    it covers at least ``min_coverage`` of the nnz. Returns a
    :class:`SumOperator`, the banded part alone when nothing remains, or
    None (the reference's rule)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1] or A.nnz == 0:
        return None
    C = A.tocoo()
    d = C.col - C.row
    offs_all, inv, counts = np.unique(d, return_inverse=True,
                                      return_counts=True)
    good = counts / n >= min_fill
    good |= offs_all == 0       # the main diagonal keeps diagonal() exact
    if good.sum() == 0 or good.sum() > max_diags:
        return None
    if counts[good].sum() < min_coverage * A.nnz:
        return None
    sel = good[inv]
    offsets = tuple(int(o) for o in offs_all[good])
    vals = np.zeros((len(offsets), n), dtype=A.dtype)
    band_of = np.searchsorted(offs_all[good], d[sel])
    vals[band_of, C.row[sel]] = C.data[sel]
    banded = BandedOperator(offsets, vals, shape=A.shape)
    if int((~sel).sum()) == 0:
        return banded
    rem = sp.coo_matrix((C.data[~sel], (C.row[~sel], C.col[~sel])),
                        shape=A.shape)
    return SumOperator([banded, ELLOperator.from_scipy(rem)])


def rcm_banded(A, max_diags: int = 256, fill_factor: float = 32.0,
               mem_cap_bytes: int = 1 << 30):
    """The reference's sparse format chooser (``operators.rcm_banded``):
    the same decisions in the same order, with the same thresholds. The
    banded (DIA) layout on the natural ordering, then on the reverse
    Cuthill-McKee ordering; the DIA+ELL hybrid on each; the windowed-slot
    ELL layout (f32 or f64, n >= 4096) of the RCM ordering; BlockELL with
    8 x 8 or 4 x 4 tiles. Returns ``(operator, perm-or-None)``, or None
    (the caller then uses :func:`aslinearoperator`); a non-None perm means
    the operator acts on ``P A P^T``."""
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
        return BandedOperator.from_scipy(A.todia()), None
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    Ap = A[perm][:, perm]
    if _accept(Ap):
        return BandedOperator.from_scipy(Ap.todia()), perm
    h = dia_ell_hybrid(A, max_diags=max_diags)
    if h is not None:
        return h, None
    hp = dia_ell_hybrid(Ap, max_diags=max_diags)
    if hp is not None:
        return hp, perm
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
            return BlockELLOperator.from_scipy(Ap, block_size=b), perm
    return None
