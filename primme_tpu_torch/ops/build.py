"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``primme_tpu_torch/_build/lib<name>-<hash>.so`` at first use,
then loaded with ``ctypes``. The hash is of the source and the flags, so an
edited source rebuilds and a built one is reused. Nothing here runs at
import time: the machine without a CUDA toolkit imports this module too.
:func:`build_once` is the same build step for any compiler
(``primme_tpu_torch/native.py`` builds its host C++ libraries with it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the "
            "CUDA kernels of primme_tpu_torch are built on a machine with "
            "the CUDA toolkit")
    return path


def hashed_path(src: str, flags, stem: str, headers=()) -> str:
    """``_build/lib<stem>-<hash>.so``, the hash of ``src``'s bytes, those of
    the ``headers`` it includes and the flags it is built with."""
    digest = hashlib.sha256()
    for path in (src, *headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def headers() -> list:
    """The ``csrc/*.cuh`` headers the kernels' sources include."""
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cuh"))


def build_once(out: str, command, what: str) -> str:
    """Build ``out`` unless it exists: ``command(tmp)`` is the compiler's
    command line writing ``tmp``, a private name in ``BUILD_DIR`` that is
    renamed to ``out`` once it is whole, so a concurrent build never sees
    a half-written library. Raises RuntimeError with the compiler's output
    when it fails."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library_path(name: str) -> str:
    return hashed_path(os.path.join(CSRC, name + ".cu"), NVCC_FLAGS, name,
                       headers())


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = load_source(os.path.join(CSRC, name + ".cu"),
                                          name)
    return lib


def load_source(src: str, stem: str) -> ctypes.CDLL:
    """Compile the CUDA source ``src`` (which may include the ``csrc``
    headers) into ``_build/lib<stem>-<hash>.so`` if missing, and load it."""
    out = build_once(hashed_path(src, NVCC_FLAGS, stem, headers()),
                     lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                     f"nvcc for {os.path.basename(src)}")
    return ctypes.CDLL(out)
