"""The shift-aware Jacobi preconditioner apply on an ``[n, k]`` block, with
the diagonal ``d [n]`` and, for the shifted form, one shift per column
``sigma [k]``, real (f32, f64) or complex (complex64, complex128):

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
``X / den`` would be.

* :func:`shifted_reference`, :func:`unshifted_reference` — plain PyTorch;
* :func:`shifted`, :func:`unshifted` — the kernel wrappers: on a CUDA tensor
  they launch the hand-written Hopper kernel (``csrc/jacobi.cu``) or raise;
  on a CPU tensor, where no kernel exists, they run the plain version;
* :func:`plan` — the real kernel's launch: columns of a row group, load
  width and grid; :func:`complex_blocks` — the complex kernel's grid.

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
KERNEL_LAUNCHES = {"jacobi_shifted_f32": 0, "jacobi_shifted_f64": 0,
                   "jacobi_f32": 0, "jacobi_f64": 0,
                   "jacobi_shifted_c64": 0, "jacobi_shifted_c128": 0,
                   "jacobi_c64": 0, "jacobi_c128": 0}
VECTOR_LAUNCHES = dict.fromkeys(KERNEL_LAUNCHES, 0)
_SUFFIX = {torch.float32: ("f32", ctypes.c_float),
           torch.float64: ("f64", ctypes.c_double),
           torch.complex64: ("c64", ctypes.c_float),
           torch.complex128: ("c128", ctypes.c_double)}
THREADS = 256        # threads a block: the kernel's kThreads
ROWS = 4             # rows a thread loads at once: the kernel's kRows
MAX_COMPLEX_BLOCKS = 1 << 20   # the complex kernel's grid-stride grid cap


def _eps(eps, dtype):
    # eps rounds to the real dtype first, as the reference's scalar does;
    # as a Python float it then stays exact and needs no copy to the device
    return float(torch.tensor(eps, dtype=dtype))


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
    blocks: int    # blocks of THREADS threads, kc / vw of them a row, each
                   # thread ROWS rows


def plan(n, k, ldx, align, size) -> Plan:
    """The launch for ``n`` rows of ``k`` columns, X's rows ``ldx``
    elements apart at an address with ``align = data_ptr % 16``, ``size``
    bytes an element: ``kc / vw`` threads to a row, one vector each,
    ``ROWS`` rows a thread, in one pass over as many blocks as the rows
    need. Raises ValueError on a shape the kernel does not take (its row
    index is 32-bit)."""
    if n < 1 or k < 1:
        raise ValueError(f"an [{n}, {k}] block has no element to launch for")
    kc = column_group(k)
    vw = vector_width(kc, ldx, align, size)
    rows = THREADS // (kc // vw) * ROWS   # rows a block takes
    blocks = -(-n // rows)
    if k >= 2 ** 31 or blocks * rows >= 2 ** 31:
        raise ValueError(f"an [{n}, {k}] block is outside the kernel's range "
                         "(n < 2**31 rounded up to whole blocks, k < 2**31)")
    return Plan(kc, vw, blocks)


def complex_blocks(n, k) -> int:
    """Blocks of ``THREADS`` threads the complex kernel walks the ``n k``
    elements with: one an element up to ``MAX_COMPLEX_BLOCKS`` blocks, a
    grid-stride loop past it."""
    if n < 1 or k < 1:
        raise ValueError(f"an [{n}, {k}] block has no element to launch for")
    return min(-(-n * k // THREADS), MAX_COMPLEX_BLOCKS)


def card_plan(X) -> Plan:
    """The plan :func:`shifted` or :func:`unshifted` launches X with."""
    return plan(X.shape[0], X.shape[1], max(X.stride(0), 1),
                X.data_ptr() % 16, X.element_size())


def _jacobi_fn(entry, eps_type, shifted_form, complex_form):
    """The C entry point ``entry`` of ``csrc/jacobi.cu``."""
    from . import build
    fn = getattr(build.load("jacobi"), entry)
    if fn.argtypes is None:
        ptrs = [ctypes.c_void_p] * (4 if shifted_form else 3)
        if complex_form:
            # X, d, [sigma,] Y; n; k; ldx; eps; blocks; stream
            fn.argtypes = ptrs + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_longlong, eps_type, ctypes.c_int,
                                  ctypes.c_void_p]
        else:
            # X, d, [sigma,] Y; n, k; ldx; eps; kc, vw, blocks; stream
            fn.argtypes = ptrs + [ctypes.c_int] * 2 \
                + [ctypes.c_longlong, eps_type] + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
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
                        "complex64 or complex128")
    n, k = X.shape
    named = [("d", d)]
    if sigma is not None:
        if sigma.ndim != 1 or sigma.shape[0] != k:
            raise ValueError(f"sigma shape {tuple(sigma.shape)} is not [{k}]")
        named.append(("sigma", sigma))
    for name, t in named:
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if t.dtype != X.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, X {X.dtype}")
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
    complex_form = X.is_complex()
    entry = ("jacobi_shifted_" if shifted_form else "jacobi_") + suffix
    fn = _jacobi_fn(entry, eps_type, shifted_form, complex_form)
    ptrs = [X.data_ptr(), d.data_ptr()] \
        + ([sigma.data_ptr()] if shifted_form else []) + [Y.data_ptr()]
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        if complex_form:
            vector = False
            rc = fn(*ptrs, n, k, max(ldx, 1), float(eps),
                    complex_blocks(n, k), stream)
        else:
            p = card_plan(X)
            vector = p.vw > 1
            rc = fn(*ptrs, n, k, max(ldx, 1), float(eps), p.kc, p.vw,
                    p.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
    VECTOR_LAUNCHES[entry] += vector
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
