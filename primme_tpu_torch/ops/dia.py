"""The DIA (diagonal storage) product of a banded matrix on an ``[n, k]``
block. The matrix is ``B`` diagonals: ``offsets`` (Python ints, in the
stored order) and ``vals [B, n]`` row-indexed, ``vals[b, i] = A[i, i +
offsets[b]]`` (the ends of a diagonal are padding):

* matmat: ``y_i = sum_b vals[b, i] * x_{i + off_b}``;
* rmatmat (``A^H``): ``y_i = sum_b conj(vals[b, i - off_b]) * x_{i -
  off_b}``;

a term whose row lies outside ``[0, n)`` counting as 0. Values are f32,
f64, f16, bf16, complex64 or complex128, each type with its own entry
point (in a half type each product and sum rounds to it, as the JAX
function computed op by op does). Half values with an f32 or f64 block
(a half basis hands a half operator f32 blocks) take a mixed entry point
(``dia_f16_f32``, ...): the values widened, the sum in the block's type,
as the JAX function's product promotes.

* :func:`matmat_reference`, :func:`rmatmat_reference` — plain PyTorch, the
  reference's loop (``primme_tpu/operators.py::BandedOperator``): ``out =
  0``, then ``out = out + v * shift(X)`` for each offset in stored order;
  a complex product is computed on the real and imaginary parts, ``(vr xr
  - vi xi, vr xi + vi xr)``, each operation rounded once, as the kernel
  does;
* :func:`matmat` — the kernel wrapper (``adjoint=True`` for rmatmat): on a
  CUDA tensor it launches the hand-written Hopper kernel (``csrc/dia.cu``)
  or raises; on a CPU tensor, where no kernel exists, it runs the plain
  version;
* :func:`plan` — the kernel's launch: which kernel, columns of a thread,
  load width (or rows) and grid; :func:`launch` — the kernel under a given
  plan.

The kernel takes X's row stride, so a column slice of a wider block needs
no copy; its columns must be adjacent. ``LAUNCHES`` counts the wrapper's
kernel launches, ``KERNEL_LAUNCHES`` the same by entry point,
``VECTOR_LAUNCHES`` those of them that loaded X in vectors (``vw > 1``)
and ``MIXED_LAUNCHES`` those that ran the mixed kernel
(``MIXED_KERNEL``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from .stencil3d import column_group, vector_width

LAUNCHES = 0         # kernel launches made by matmat
_ENTRY = {torch.float32: "dia_f32", torch.float64: "dia_f64",
          torch.float16: "dia_f16", torch.bfloat16: "dia_bf16",
          torch.complex64: "dia_c64", torch.complex128: "dia_c128"}
# half values with a wider real block: (vals dtype, X dtype) -> entry
_MIXED = {(h, b): f"dia_{hs}_{bs}"
          for h, hs in ((torch.float16, "f16"), (torch.bfloat16, "bf16"))
          for b, bs in ((torch.float32, "f32"), (torch.float64, "f64"))}
KERNEL_LAUNCHES = dict.fromkeys([*_ENTRY.values(), *_MIXED.values()], 0)
VECTOR_LAUNCHES = dict.fromkeys(KERNEL_LAUNCHES, 0)
MIXED_LAUNCHES = dict.fromkeys(KERNEL_LAUNCHES, 0)
THREADS = 256        # threads of a block: the kernel's kThreads
MAX_GRID_Y = 65535   # CUDA's limit on gridDim.y: column groups


def _shift_rows(X, off):
    """Rows ``i + off`` of X for i in [0, n), zero rows where that lies
    outside (the reference's ``jnp.pad`` of a slice)."""
    n = X.shape[0]
    m = max(0, n - abs(off))            # rows that stay inside
    zeros = X.new_zeros((n - m, X.shape[1]))
    if off >= 0:
        return torch.cat([X[off:off + m], zeros])
    return torch.cat([zeros, X[:m]])


def _check(vals, offsets, X):
    if vals.ndim != 2 or vals.shape[0] != len(offsets):
        raise ValueError(f"vals shape {tuple(vals.shape)} is not "
                         f"[{len(offsets)}, n] for {len(offsets)} offsets")
    if X.ndim != 2 or X.shape[0] != vals.shape[1]:
        raise ValueError(f"X shape {tuple(X.shape)} is not "
                         f"[{vals.shape[1]}, k]")


def _madd(out, v, x):
    """``out + v * x``, each operation rounded once; a complex product on
    the parts, ``(vr xr - vi xi, vr xi + vi xr)``, then the sum part by
    part (no fused multiply-add: the kernel's order)."""
    if not out.is_complex():
        return out + v * x
    vr, vi = v.real, v.imag
    xr, xi = x.real, x.imag
    return torch.complex(out.real + (vr * xr - vi * xi),
                         out.imag + (vr * xi + vi * xr))


def _promoted(vals, X):
    """``vals`` in the type the product computes in: X's for half values and
    a wider real X (the widening is exact), its own otherwise."""
    return vals.to(X.dtype) if (vals.dtype, X.dtype) in _MIXED else vals


def matmat_reference(vals, offsets: Sequence[int], X):
    """Plain PyTorch ``Y = A X`` in the type of ``vals`` (X's for half values
    and an f32 or f64 X): for each offset in stored order ``out = out + v *
    shift(X)``, each product and sum rounded once."""
    _check(vals, offsets, X)
    vals = _promoted(vals, X)
    X = X.to(vals.dtype)
    out = torch.zeros((X.shape[0], X.shape[1]), dtype=vals.dtype,
                      device=X.device)
    for b, off in enumerate(offsets):
        xs = X if off == 0 else _shift_rows(X, off)
        out = _madd(out, vals[b][:, None], xs)
    return out


def rmatmat_reference(vals, offsets: Sequence[int], X):
    """Plain PyTorch ``Y = A^H X``: the diagonal at ``off`` adds
    ``conj(vals[b, i - off]) * x_{i - off}``, both shifted with zeros, for
    each offset in stored order."""
    _check(vals, offsets, X)
    vals = _promoted(vals, X)
    X = X.to(vals.dtype)
    out = torch.zeros((X.shape[0], X.shape[1]), dtype=vals.dtype,
                      device=X.device)
    for b, off in enumerate(offsets):
        v = vals[b][:, None].conj().resolve_conj()
        if off == 0:
            out = _madd(out, v, X)
        else:
            out = _madd(out, _shift_rows(v, -off), _shift_rows(X, -off))
    return out


# the kernels of csrc/dia.cu (its KernelId)
ROW_KERNEL = 0   # dia_kernel: one row a thread (f32, f64, complex; mixed
                 # past MIXED_MAX_N rows)
HALF_KERNEL = 1  # dia_half_kernel: HALF_ROWS rows a thread, 32 apart
RUN_KERNEL = 2   # dia_run_kernel: RUN_ROWS adjacent rows, X one column
MIXED_KERNEL = 3  # dia_mixed_kernel: one row a thread, the offsets staged
                  # once a block (half values, f32 or f64 block)
HALF_ROWS = 2
RUN_ROWS = 4
MIXED_MAX_N = 2 ** 30   # the mixed kernel's rows are 32-bit with a shift
MIXED_MAX_B = 12288     # the mixed kernel's offsets fill 48 KB of shared
                        # memory


class Plan(NamedTuple):
    kc: int        # columns of a thread (divides k)
    vw: int        # elements of X a thread loads at once; 1 is the scalar
                   # path (RUN_KERNEL: its RUN_ROWS rows, one run)
    grid: tuple    # (blocks of THREADS threads, column groups k / kc)
    kernel: int = ROW_KERNEL

    @property
    def rows(self) -> int:
        """Rows of a thread."""
        return {HALF_KERNEL: HALF_ROWS, RUN_KERNEL: RUN_ROWS}.get(
            self.kernel, 1)


def plan(n, k, ldx, align, size, vals_size=None, diagonals=0) -> Plan:
    """The launch for ``n`` rows of ``k`` columns, X's rows ``ldx``
    elements apart at an address with ``align = data_ptr % 16``, ``size``
    bytes an element of X, ``vals_size`` bytes a value (default ``size``)
    and ``diagonals`` of them a row:
    one thread a row and group of ``kc`` columns, X loaded
    :func:`vector_width` at a time, blocks of ``THREADS`` threads
    (``ROW_KERNEL``). A half block (``size`` 2, which holds half values)
    takes the packed kernels: ``HALF_KERNEL``, two rows a thread 32 apart,
    or where X is one column (``kc`` 1, ``ldx`` 1) ``RUN_KERNEL``, four
    adjacent rows whose X is one run; blocks of ``THREADS * rows`` rows.
    Half values with an f32 or f64 block (the mixed entry points) take
    ``MIXED_KERNEL`` under the same thread map as ``ROW_KERNEL`` where
    ``n < MIXED_MAX_N``, ``ldx < 2**31`` (its 32-bit rows and row stride)
    and ``diagonals <= MIXED_MAX_B`` (its offsets in shared memory), else
    ``ROW_KERNEL``. Raises ValueError on a shape the kernels do not
    take."""
    if n < 1 or k < 1 or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"an [{n}, {k}] block is outside the kernel's range "
                         "(1 <= n, k < 2**31)")
    kc = column_group(k)
    groups = k // kc
    if groups > MAX_GRID_Y:
        raise ValueError(f"{groups} column groups of {kc}: the grid takes "
                         f"{MAX_GRID_Y}")
    p = Plan(kc, vector_width(kc, ldx, align, size), (1, groups))
    if size == 2 and kc == 1 and ldx == 1:
        p = p._replace(vw=RUN_ROWS, kernel=RUN_KERNEL)
    elif size == 2:
        p = p._replace(kernel=HALF_KERNEL)
    elif (vals_size == 2 and n < MIXED_MAX_N and ldx < 2 ** 31
          and diagonals <= MIXED_MAX_B):
        p = p._replace(kernel=MIXED_KERNEL)
    return p._replace(grid=(-(-n // (THREADS * p.rows)), groups))


def card_plan(X, vals=None) -> Plan:
    """The plan :func:`matmat` launches the CUDA tensor X with, over the
    values ``vals`` (default: of X's type)."""
    return plan(X.shape[0], X.shape[1], max(X.stride(0), 1),
                X.data_ptr() % 16, X.element_size(),
                *(() if vals is None else (vals.element_size(),
                                           vals.shape[0])))


def _dia_fn(entry):
    """The C entry point ``entry`` of ``csrc/dia.cu``."""
    from . import build
    fn = getattr(build.load("dia"), entry)
    if fn.argtypes is None:
        # vals, offs; B; X; ldx; Y; n, k, adjoint, kernel, kc, vw, gx,
        # gy; stream
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                               ctypes.c_longlong,
                                               ctypes.c_void_p] \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def matmat(vals, offs, X, adjoint=False):
    """``Y = A X`` (``adjoint``: ``A^H X``) for an ``[n, k]`` block in the
    type of ``vals`` (f32, f64, f16, bf16, complex64 or complex128), X of
    the same type (or f32 or f64 for half values: Y in X's type), the
    offsets an i64
    tensor ``offs [B]`` on X's device in stored order. CUDA tensors: the
    hand-written kernel of ``csrc/dia.cu`` on the current stream, launched
    as :func:`plan` says (raises on a bad argument or a refused launch).
    CPU tensors: the plain version."""
    global LAUNCHES
    if X.device.type == "cpu":
        return (rmatmat_reference if adjoint else matmat_reference)(
            vals, offs.tolist(), X)
    if X.device.type != "cuda":
        raise ValueError(f"dia matmat: unsupported device {X.device}")
    if tuple(offs.shape) != (vals.shape[0],):
        raise ValueError(f"offs shape {tuple(offs.shape)} != "
                         f"({vals.shape[0]},)")
    _check(vals, range(vals.shape[0]), X)
    if vals.dtype not in _ENTRY:
        raise TypeError(f"vals has dtype {vals.dtype}, expected float32, "
                        "float64, float16, bfloat16, complex64 or "
                        "complex128")
    mixed = _MIXED.get((vals.dtype, X.dtype))
    for name, t, dt in (("vals", vals, vals.dtype),
                        ("X", X, X.dtype if mixed else vals.dtype),
                        ("offs", offs, torch.int64)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt}")
    if not vals.is_contiguous() or not offs.is_contiguous():
        raise ValueError("vals and offs must be contiguous")
    n, k = X.shape
    ldx = X.stride(0)
    if k > 1 and X.stride(1) != 1:
        raise ValueError("X's columns are not adjacent (stride "
                         f"{tuple(X.stride())})")
    if ldx < k:
        raise ValueError(f"X's rows overlap (row stride {ldx} < {k} columns)")
    Y = torch.empty((n, k), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    if vals.shape[0] == 0:
        return Y.zero_()
    p = card_plan(X, vals)
    entry = launch(vals, offs, X, Y, adjoint, p)
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
    VECTOR_LAUNCHES[entry] += p.vw > 1
    MIXED_LAUNCHES[entry] += p.kernel == MIXED_KERNEL
    return Y


def launch(vals, offs, X, Y, adjoint, p: Plan):
    """Launches the entry point of (vals, X)'s types on the current stream
    under plan ``p``: ``Y = A X`` (``adjoint``: ``A^H X``) into the
    contiguous ``[n, k]`` Y; returns the entry point's name. Counts
    nothing (:func:`matmat` does); raises when the launch is refused."""
    entry = _MIXED.get((vals.dtype, X.dtype)) or _ENTRY[X.dtype]
    fn = _dia_fn(entry)
    n, k = X.shape
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(vals.data_ptr(), offs.data_ptr(), vals.shape[0], X.data_ptr(),
                max(X.stride(0), 1), Y.data_ptr(), n, k, int(adjoint),
                p.kernel, p.kc, p.vw, *p.grid, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return entry
