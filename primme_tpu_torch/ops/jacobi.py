"""The shift-aware Jacobi preconditioner apply on an ``[n, k]`` block, with
the diagonal ``d [n]`` and, for the shifted form, one shift per column
``sigma [k]``, real (f32, f64, and the half types f16 and bf16) or complex
(complex64, complex128):

* shifted: ``Y[:, j] = X[:, j] / den_j`` with ``den_j = d - sigma_j``;
* unshifted: ``Y = (1 / den)[:, None] * X`` with ``den = d``;

where a ``den`` with ``|den| < eps`` is replaced by ``eps`` (a NaN stays
NaN; a complex ``den`` is compared by its modulus and becomes ``eps +
0i``). The two round differently (one division against a reciprocal and a
product); each keeps the form of ``primme_tpu/operators.py::JacobiPrecond``.
A complex division is the one of torch's complex type (``c10::complex``'s
Smith branches), written out on the real and imaginary parts with one
rounding an operation (:func:`complex_divide`), so that the kernel and its
plain version agree bit for bit whatever the card's contraction of
``X / den`` would be. In a half type every operation rounds to it (``eps``
too: 1e-10 is 0 in f16, so a zero ``den`` stays and ``X / 0`` is an
infinity, as in the reference), as the JAX function computed op by op does.
A half ``d`` with an f32 or f64 block (and shifts: a half basis hands a
half operator f32 ones) takes a mixed entry point (``jacobi_f16_f32``,
...): the JAX function promotes there, so the shifted form is ``d``
widened and the rest in the block's type, the unshifted one the
reciprocal in the half type times X in the block's type; the plain
versions, torch's promotion, compute the same.

* :func:`shifted_reference`, :func:`unshifted_reference` — plain PyTorch;
* :func:`shifted`, :func:`unshifted` — the kernel wrappers: on a CUDA tensor
  they launch the hand-written Hopper kernel (``csrc/jacobi.cu``) or raise;
  on a CPU tensor, where no kernel exists, they run the plain version;
* :func:`plan` — the kernel's launch for every type: columns of a row
  group, load width, columns a thread holds and grid.

The kernels take X's row stride; its columns must be adjacent.
``LAUNCHES`` counts the wrappers' kernel launches, ``KERNEL_LAUNCHES`` the
same by entry point and ``VECTOR_LAUNCHES`` those of them that loaded X in
vectors (``vw > 1``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .stencil3d import column_group, vector_width

LAUNCHES = 0         # kernel launches made by shifted and unshifted
# each dtype's entry-point suffix and the C type of its eps (a half kernel
# takes the f32 value of the half eps)
_SUFFIX = {torch.float32: ("f32", ctypes.c_float),
           torch.float64: ("f64", ctypes.c_double),
           torch.float16: ("f16", ctypes.c_float),
           torch.bfloat16: ("bf16", ctypes.c_float),
           torch.complex64: ("c64", ctypes.c_float),
           torch.complex128: ("c128", ctypes.c_double)}
# a half d with a wider real block: (d dtype, X dtype) -> suffix
_MIXED = {(h, b): f"{hs}_{_SUFFIX[b][0]}"
          for h, hs in ((torch.float16, "f16"), (torch.bfloat16, "bf16"))
          for b in (torch.float32, torch.float64)}
KERNEL_LAUNCHES = {f"jacobi{form}_{suffix}": 0
                   for form in ("_shifted", "")
                   for suffix in [s for s, _ in _SUFFIX.values()]
                   + list(_MIXED.values())}
VECTOR_LAUNCHES = dict.fromkeys(KERNEL_LAUNCHES, 0)
THREADS = 256        # threads a block: the kernel's kThreads
ROWS = 4             # rows a real thread loads at once (a complex one: 1)
COMPLEX_BYTES = 16   # bytes of its row group a complex thread holds


def _eps(eps, dtype):
    # eps rounds to the real dtype first, as the reference's scalar does;
    # as a Python float it then stays exact and needs no copy to the device
    return float(torch.tensor(eps, dtype=dtype))


def _kernel_eps(eps, dtype):
    """eps as the kernel takes it: a half kernel the f32 value of the half
    it rounds to (1e-10 is 0 in f16); the others round it themselves."""
    if dtype in (torch.float16, torch.bfloat16):
        return _eps(eps, dtype)
    return float(eps)


def _guard(den, eps):
    e = _eps(eps, den.dtype)
    return torch.where(torch.abs(den) < e, e, den)


def _guard_parts(re, im, eps):
    """A complex ``den`` as its parts, ``eps + 0i`` where ``|den| < eps``
    (``hypot``, as the kernel takes the modulus)."""
    e = _eps(eps, re.dtype)
    small = torch.hypot(re, im) < e
    return torch.where(small, e, re), torch.where(small, 0.0, im)


def complex_divide(a, b, c, d):
    """``(a + ib) / (c + id)`` on the parts, as ``c10::complex`` divides
    (numpy's algorithm): Smith's branch on ``|c| >= |d|``, one rounding an
    operation. Returns ``(re, im)``."""
    big = torch.abs(c) >= torch.abs(d)
    zero = (c == 0) & (d == 0)
    rat1 = d / c
    scl1 = torch.reciprocal(c + d * rat1)
    re1 = torch.where(zero, a / torch.abs(c), (a + b * rat1) * scl1)
    im1 = torch.where(zero, b / torch.abs(d), (b - a * rat1) * scl1)
    rat2 = c / d
    scl2 = torch.reciprocal(d + c * rat2)
    re2 = (a * rat2 + b) * scl2
    im2 = (b * rat2 - a) * scl2
    return torch.where(big, re1, re2), torch.where(big, im1, im2)


def shifted_reference(X, d, sigma, eps):
    """Plain PyTorch ``X / guard(d[:, None] - sigma[None, :])``; complex
    on the parts (:func:`complex_divide`)."""
    if not X.is_complex():
        return X / _guard(d[:, None] - sigma[None, :], eps)
    dr, di = _guard_parts(d.real[:, None] - sigma.real[None, :],
                          d.imag[:, None] - sigma.imag[None, :], eps)
    return torch.complex(*complex_divide(X.real, X.imag, dr, di))


def unshifted_reference(X, d, eps):
    """Plain PyTorch ``reciprocal(guard(d))[:, None] * X``; complex on the
    parts: the reciprocal a division of ``1 + 0i``, then the product
    ``(ir xr - ii xi, ir xi + ii xr)``."""
    if not X.is_complex():
        return torch.reciprocal(_guard(d, eps))[:, None] * X
    dr, di = _guard_parts(d.real, d.imag, eps)
    ir, ii = complex_divide(torch.ones_like(dr), torch.zeros_like(dr), dr, di)
    ir, ii = ir[:, None], ii[:, None]
    xr, xi = X.real, X.imag
    return torch.complex(ir * xr - ii * xi, ir * xi + ii * xr)


class Plan(NamedTuple):
    kc: int        # columns of a row group (divides k)
    vw: int        # elements of X per load; 1 is the scalar path
    blocks: int    # blocks of THREADS threads, kc / cols of them a row
    cols: int      # columns of its row group a thread holds: vw for a real
                   # type, COMPLEX_BYTES of the group for a complex one
    rows: int      # rows a thread takes: ROWS for a real type, 1 complex


def plan(n, k, ldx, align, size, is_complex=False) -> Plan:
    """The launch for ``n`` rows of ``k`` columns, X's rows ``ldx``
    elements apart at an address with ``align = data_ptr % 16``, ``size``
    bytes an element (4 or 8 real, 8 or 16 complex with ``is_complex``):
    ``kc / cols`` threads to a row, ``rows`` rows a thread, in one pass
    over as many blocks as the rows need. A real thread holds one vector
    of ``vw`` columns in ``ROWS`` rows; a complex one ``COMPLEX_BYTES`` of
    its group, ``vw`` columns a load, in one row (the kernel's ``Shape``).
    Raises ValueError on a shape the kernel does not take (its row index
    is 32-bit; an address must hold whole elements)."""
    if n < 1 or k < 1:
        raise ValueError(f"an [{n}, {k}] block has no element to launch for")
    if align % size:
        raise ValueError(f"X's address is {align} bytes past 16, not a "
                         f"multiple of its {size}-byte elements")
    kc = column_group(k)
    vw = vector_width(kc, ldx, align, size)
    cols = min(kc, COMPLEX_BYTES // size) if is_complex else vw
    rows = 1 if is_complex else ROWS
    per_block = THREADS // (kc // cols) * rows
    blocks = -(-n // per_block)
    if k >= 2 ** 31 or blocks * per_block >= 2 ** 31:
        raise ValueError(f"an [{n}, {k}] block is outside the kernel's range "
                         "(n < 2**31 rounded up to whole blocks, k < 2**31)")
    return Plan(kc, vw, blocks, cols, rows)


def card_plan(X) -> Plan:
    """The plan :func:`shifted` or :func:`unshifted` launches X with."""
    return plan(X.shape[0], X.shape[1], max(X.stride(0), 1),
                X.data_ptr() % 16, X.element_size(), X.is_complex())


def _jacobi_fn(entry, eps_type, shifted_form):
    """The C entry point ``entry`` of ``csrc/jacobi.cu``."""
    from . import build
    fn = getattr(build.load("jacobi"), entry)
    if fn.argtypes is None:
        # X, d, [sigma,] Y; n, k; ldx; eps; kc, vw, blocks; stream
        fn.argtypes = [ctypes.c_void_p] * (4 if shifted_form else 3) \
            + [ctypes.c_int] * 2 + [ctypes.c_longlong, eps_type] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(X, d, sigma, eps):
    global LAUNCHES
    if X.device.type != "cuda":
        raise ValueError(f"jacobi: unsupported device {X.device}")
    if X.ndim != 2 or d.ndim != 1 or d.shape[0] != X.shape[0]:
        raise ValueError(f"X shape {tuple(X.shape)} and d shape "
                         f"{tuple(d.shape)} do not match ([n, k] and [n])")
    if X.dtype not in _SUFFIX:
        raise TypeError(f"X has dtype {X.dtype}, expected float32, float64, "
                        "float16, bfloat16, complex64 or complex128")
    n, k = X.shape
    mixed = _MIXED.get((d.dtype, X.dtype))
    named = [("d", d, d.dtype if mixed else X.dtype)]
    if sigma is not None:
        if sigma.ndim != 1 or sigma.shape[0] != k:
            raise ValueError(f"sigma shape {tuple(sigma.shape)} is not [{k}]")
        named.append(("sigma", sigma, X.dtype))
    for name, t, dt in named:
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt} "
                            f"(X {X.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    ldx = X.stride(0)
    if k > 1 and X.stride(1) != 1:
        raise ValueError("X's columns are not adjacent (stride "
                         f"{tuple(X.stride())})")
    if ldx < k:
        raise ValueError(f"X's rows overlap (row stride {ldx} < {k} columns)")
    Y = torch.empty((n, k), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    suffix, eps_type = _SUFFIX[X.dtype]
    shifted_form = sigma is not None
    # the guard's type: the block's, but the unshifted form's reciprocal
    # is taken in d's (a half d's under a wider block)
    guard_dtype = d.dtype if mixed and not shifted_form else X.dtype
    suffix = mixed or suffix
    entry = ("jacobi_shifted_" if shifted_form else "jacobi_") + suffix
    fn = _jacobi_fn(entry, eps_type, shifted_form)
    ptrs = [X.data_ptr(), d.data_ptr()] \
        + ([sigma.data_ptr()] if shifted_form else []) + [Y.data_ptr()]
    p = card_plan(X)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, n, k, max(ldx, 1), _kernel_eps(eps, guard_dtype),
                p.kc, p.vw, p.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
    VECTOR_LAUNCHES[entry] += p.vw > 1
    return Y


def shifted(X, d, sigma, eps):
    """``X / guard(d - sigma_j)`` column by column. CUDA tensors: the
    kernel's ``jacobi_shifted_*`` entry point; CPU tensors:
    :func:`shifted_reference`."""
    if X.device.type == "cpu":
        return shifted_reference(X, d, sigma, eps)
    return _launch(X, d, sigma, eps)


def unshifted(X, d, eps):
    """``(1 / guard(d)) * X``. CUDA tensors: the kernel's ``jacobi_*``
    entry point; CPU tensors: :func:`unshifted_reference`."""
    if X.device.type == "cpu":
        return unshifted_reference(X, d, eps)
    return _launch(X, d, None, eps)
