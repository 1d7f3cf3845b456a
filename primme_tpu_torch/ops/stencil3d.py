"""The 7-point 3-D Laplacian product: ``Y = scale * (6 X - sum of the six
grid neighbours)`` on an ``nx x ny x nz`` grid with Dirichlet edges, for an
``[n, k]`` block whose rows are the grid points in the JAX package's order
(row ``(i*ny + j)*nz + l``, i.e. ``X.reshape(nx, ny, nz, k)``).

* :func:`matmat_reference` — plain PyTorch, the reference's order of
  operations (``primme_tpu/operators.py::Stencil3DOperator.matmat``);
* :func:`matmat` — the kernel wrapper: on a CUDA tensor it launches the
  hand-written Hopper kernel (``csrc/stencil3d.cu``) or raises; on a CPU
  tensor, where no kernel exists, it runs :func:`matmat_reference`.

The kernel takes X's row stride, so a column slice of a wider block needs
no copy; its columns must be adjacent. ``LAUNCHES`` counts the wrapper's
kernel launches and ``KERNEL_LAUNCHES`` the same by entry point.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0         # kernel launches made by matmat
KERNEL_LAUNCHES = {"stencil3d_f32": 0, "stencil3d_f64": 0}
_ENTRY = {torch.float32: ("stencil3d_f32", ctypes.c_float),
          torch.float64: ("stencil3d_f64", ctypes.c_double)}
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


def _check(X, nx, ny, nz):
    if X.ndim != 2 or X.shape[0] != nx * ny * nz:
        raise ValueError(f"X shape {tuple(X.shape)} is not [{nx * ny * nz}, k] "
                         f"for the {nx}x{ny}x{nz} grid")


def matmat_reference(X, nx, ny, nz, scale=1.0):
    """Plain PyTorch ``Y = scale * (6 g - sum of neighbours)`` in X's dtype:
    ``out = 6 g``, then per axis 0, 1, 2 ``out = out - g(+1) - g(-1)`` with
    0 outside the grid, then ``scale * out``; ``scale`` rounds to X's dtype
    first, as the reference's weakly typed scalar does."""
    _check(X, nx, ny, nz)
    k = X.shape[1]
    g = X.reshape(nx, ny, nz, k)
    out = 6.0 * g
    for ax in range(3):
        m = g.shape[ax]
        edge = torch.zeros_like(g.narrow(ax, 0, 1))
        up = torch.cat([g.narrow(ax, 1, m - 1), edge], dim=ax)
        down = torch.cat([edge, g.narrow(ax, 0, m - 1)], dim=ax)
        out = out - up - down
    # scale rounded to X's dtype, as a Python float: exact, no device copy
    return (float(torch.tensor(scale, dtype=X.dtype)) * out).reshape(-1, k)


def _stencil_fn(entry, scale_type):
    """The C entry point ``entry`` of ``csrc/stencil3d.cu``."""
    from . import build
    fn = getattr(build.load("stencil3d"), entry)
    if fn.argtypes is None:
        # X, Y; nx, ny, nz, k; ldx; scale; stream
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_longlong, scale_type, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def matmat(X, nx, ny, nz, scale=1.0):
    """``Y = A X`` for the 7-point Laplacian of an ``nx x ny x nz`` grid, in
    X's dtype (f32 or f64). CUDA tensors: the hand-written kernel of
    ``csrc/stencil3d.cu`` on the current stream (raises on a bad argument
    or a refused launch). CPU tensors: :func:`matmat_reference`."""
    global LAUNCHES
    if X.device.type == "cpu":
        return matmat_reference(X, nx, ny, nz, scale)
    if X.device.type != "cuda":
        raise ValueError(f"stencil3d matmat: unsupported device {X.device}")
    _check(X, nx, ny, nz)
    if X.dtype not in _ENTRY:
        raise TypeError(f"X has dtype {X.dtype}, expected float32 or float64")
    k = X.shape[1]
    ldx = X.stride(0)
    if k > 1 and X.stride(1) != 1:
        raise ValueError("X's columns are not adjacent (stride "
                         f"{tuple(X.stride())})")
    if ldx < k:
        raise ValueError(f"X's rows overlap (row stride {ldx} < {k} columns)")
    if max(nx, ny) > _MAX_GRID_YZ or nz * k >= 2 ** 31:
        raise ValueError(f"grid {nx}x{ny}x{nz} at k={k} exceeds the "
                         "kernel's launch grid")
    Y = torch.empty((nx * ny * nz, k), dtype=X.dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    entry, scale_type = _ENTRY[X.dtype]
    fn = _stencil_fn(entry, scale_type)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(X.data_ptr(), Y.data_ptr(), nx, ny, nz, k, max(ldx, 1),
                float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES += 1
    KERNEL_LAUNCHES[entry] += 1
    return Y
