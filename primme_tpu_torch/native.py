"""ctypes bindings to the port's native C++ helpers, and their builds.

The port of ``primme_tpu/native.py``, with its own sources under
``primme_tpu_torch/native/`` (copies of the JAX package's ``native/``):

* ``mmio_ell.cpp``: the native analogue of the reference's C I/O stack
  (``tests/COMMON/mmio.c`` + ``ssrcsr.c``): a fast MatrixMarket parse with
  symmetry expansion and direct COO->ELL packing (:func:`read_mtx_coo`,
  :func:`coo_to_ell`). Host-only: it touches no device and no kernel.
  When the library cannot be built these return None and
  :mod:`primme_tpu_torch.io` reads through scipy (:func:`available`).
* ``capi.cpp``: the C/Fortran ABI (``ptpu_*``), which embeds CPython and
  forwards into :mod:`primme_tpu_torch.capi_support`;
  :func:`capi_library` builds it.

Each builds with ``g++ -shared -fPIC`` at first use into
``primme_tpu_torch/_build/lib<name>-<hash>.so``, the hash of the source and
the flags (``ops/build.py``'s step: atomic rename, an edited source
rebuilds). Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sysconfig
from typing import Optional, Tuple

import numpy as np

from .ops import build

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) to build the "
                           "native libraries of primme_tpu_torch")
    return cxx


def python_build_flags():
    """``(include dir, library dir, library name)`` of the running
    interpreter's ``Python.h`` and shared ``libpython``: what a program
    that embeds it compiles and links against."""
    return (sysconfig.get_paths()["include"],
            sysconfig.get_config_var("LIBDIR"),
            "python" + sysconfig.get_config_var("LDVERSION"))


def missing_build_prerequisites():
    """The files :func:`capi_library` needs that the running machine lacks
    (``Python.h``, the shared ``libpython``), as paths; empty when it can
    build."""
    inc, libdir, lib = python_build_flags()
    missing = []
    if not os.path.exists(os.path.join(inc, "Python.h")):
        missing.append(os.path.join(inc, "Python.h"))
    so = os.path.join(libdir or "", f"lib{lib}.so")
    if not os.path.exists(so):
        missing.append(so)
    return missing


def capi_library() -> str:
    """Build (at first use) the C/Fortran ABI ``libprimme_tpu_torch_capi``
    and return its path. Link a C program with ``-L<dir> -l:<file>
    -Wl,-rpath,<dir>``; run it with ``PYTHONPATH`` holding the repository
    and the interpreter's site-packages (``sysconfig``'s ``purelib``)."""
    inc, libdir, lib = python_build_flags()
    link = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{lib}"]
    src = os.path.join(SRC_DIR, "capi.cpp")
    out = build.hashed_path(src, [*CXXFLAGS, f"-I{inc}", *link],
                            "primme_tpu_torch_capi")
    return build.build_once(
        out, lambda tmp: [_cxx(), *CXXFLAGS, f"-I{inc}", "-o", tmp, src,
                          *link],
        "g++ for native/capi.cpp")


def native_library() -> str:
    """Build (at first use) ``libprimme_tpu_torch_native`` (the MatrixMarket
    parse and ELL pack) and return its path."""
    src = os.path.join(SRC_DIR, "mmio_ell.cpp")
    out = build.hashed_path(src, CXXFLAGS, "primme_tpu_torch_native")
    return build.build_once(
        out, lambda tmp: [_cxx(), *CXXFLAGS, "-o", tmp, src],
        "g++ for native/mmio_ell.cpp")


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(native_library())
    except (RuntimeError, OSError):
        # no compiler, or no loadable library: the documented scipy path
        return None
    lib.ptn_mtx_open.restype = ctypes.c_int64
    lib.ptn_mtx_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32)]
    lib.ptn_mtx_read.restype = None
    lib.ptn_mtx_read.argtypes = [ctypes.c_void_p] * 4
    lib.ptn_coo_to_ell.restype = ctypes.c_int64
    lib.ptn_coo_to_ell.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def read_mtx_coo(path: str):
    """Parse a .mtx via the native library. Returns
    ``(m, n, rows, cols, values)`` with symmetry already expanded, or
    ``None`` if the native library is unavailable or the format
    unsupported."""
    lib = _lib()
    if lib is None:
        return None
    m = ctypes.c_int64()
    n = ctypes.c_int64()
    nnz = ctypes.c_int64()
    isc = ctypes.c_int32()
    ok = lib.ptn_mtx_open(path.encode(), ctypes.byref(m), ctypes.byref(n),
                          ctypes.byref(nnz), ctypes.byref(isc))
    if not ok:
        return None
    rows = np.empty(nnz.value, np.int64)
    cols = np.empty(nnz.value, np.int64)
    re = np.empty(nnz.value, np.float64)
    im = np.empty(nnz.value, np.float64) if isc.value else None
    lib.ptn_mtx_read(
        rows.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
        re.ctypes.data_as(ctypes.c_void_p),
        im.ctypes.data_as(ctypes.c_void_p) if im is not None else None)
    vals = re + 1j * im if im is not None else re
    return m.value, n.value, rows, cols, vals


def coo_to_ell(n_rows: int, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Pack COO to padded ELL (``cols [n_rows, w]`` int32, ``vals [n_rows,
    w]``, padding column 0 with value 0) via the native library; None if
    unavailable."""
    lib = _lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols64 = np.ascontiguousarray(cols, np.int64)
    cplx = np.iscomplexobj(vals)
    re = np.ascontiguousarray(vals.real, np.float64)
    im = np.ascontiguousarray(vals.imag, np.float64) if cplx else None
    nnz = len(rows)
    w = lib.ptn_coo_to_ell(n_rows, nnz,
                           rows.ctypes.data_as(ctypes.c_void_p),
                           cols64.ctypes.data_as(ctypes.c_void_p),
                           re.ctypes.data_as(ctypes.c_void_p),
                           None, 0, None, None, None)
    if w < 0:
        raise ValueError("coo_to_ell: row index out of bounds")
    out_cols = np.zeros((n_rows, w), np.int32)
    out_re = np.zeros((n_rows, w), np.float64)
    out_im = np.zeros((n_rows, w), np.float64) if cplx else None
    lib.ptn_coo_to_ell(
        n_rows, nnz,
        rows.ctypes.data_as(ctypes.c_void_p),
        cols64.ctypes.data_as(ctypes.c_void_p),
        re.ctypes.data_as(ctypes.c_void_p),
        im.ctypes.data_as(ctypes.c_void_p) if im is not None else None,
        w,
        out_cols.ctypes.data_as(ctypes.c_void_p),
        out_re.ctypes.data_as(ctypes.c_void_p),
        out_im.ctypes.data_as(ctypes.c_void_p) if out_im is not None
        else None)
    out_vals = out_re + 1j * out_im if out_im is not None else out_re
    return out_cols, out_vals
