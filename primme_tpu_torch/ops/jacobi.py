"""The shift-aware Jacobi preconditioner apply on an ``[n, k]`` block, with
the diagonal ``d [n]`` and, for the shifted form, one shift per column
``sigma [k]``:

* shifted: ``Y[:, j] = X[:, j] / den_j`` with ``den_j = d - sigma_j``;
* unshifted: ``Y = (1 / den)[:, None] * X`` with ``den = d``;

where a ``den`` with ``|den| < eps`` is replaced by ``eps`` (a NaN stays
NaN). The two round differently (one division against a reciprocal and a
product); each keeps the form of ``primme_tpu/operators.py::JacobiPrecond``.

* :func:`shifted_reference`, :func:`unshifted_reference` — plain PyTorch;
* :func:`shifted`, :func:`unshifted` — the kernel wrappers: on a CUDA tensor
  they launch the hand-written Hopper kernel (``csrc/jacobi.cu``) or raise;
  on a CPU tensor, where no kernel exists, they run the plain version.

The kernels take X's row stride; its columns must be adjacent.
``LAUNCHES`` counts the wrappers' kernel launches and ``KERNEL_LAUNCHES``
the same by entry point.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0         # kernel launches made by shifted and unshifted
KERNEL_LAUNCHES = {"jacobi_shifted_f32": 0, "jacobi_shifted_f64": 0,
                   "jacobi_f32": 0, "jacobi_f64": 0}
_SUFFIX = {torch.float32: ("f32", ctypes.c_float),
           torch.float64: ("f64", ctypes.c_double)}


def _guard(den, eps):
    # eps rounds to den's dtype first, as the reference's scalar does; as a
    # Python float it then stays exact and needs no copy to the device
    e = float(torch.tensor(eps, dtype=den.dtype))
    return torch.where(torch.abs(den) < e, e, den)


def shifted_reference(X, d, sigma, eps):
    """Plain PyTorch ``X / guard(d[:, None] - sigma[None, :])``."""
    return X / _guard(d[:, None] - sigma[None, :], eps)


def unshifted_reference(X, d, eps):
    """Plain PyTorch ``reciprocal(guard(d))[:, None] * X``."""
    return torch.reciprocal(_guard(d, eps))[:, None] * X


def _jacobi_fn(entry, eps_type, shifted_form):
    """The C entry point ``entry`` of ``csrc/jacobi.cu``."""
    from . import build
    fn = getattr(build.load("jacobi"), entry)
    if fn.argtypes is None:
        # X, d, [sigma,] Y; n, k, ldx; eps; stream
        fn.argtypes = [ctypes.c_void_p] * (4 if shifted_form else 3) \
            + [ctypes.c_longlong] * 3 + [eps_type, ctypes.c_void_p]
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
        raise TypeError(f"X has dtype {X.dtype}, expected float32 or float64")
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
    entry = ("jacobi_shifted_" if sigma is not None else "jacobi_") + suffix
    fn = _jacobi_fn(entry, eps_type, sigma is not None)
    ptrs = [X.data_ptr(), d.data_ptr()] \
        + ([sigma.data_ptr()] if sigma is not None else []) + [Y.data_ptr()]
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*ptrs, n, k, max(ldx, 1), float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
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
