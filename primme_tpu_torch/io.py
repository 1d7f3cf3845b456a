"""Matrix I/O: MatrixMarket loading into the port's operators.

The port of ``primme_tpu/io.py``. Replaces the reference test harness's
CSR MatrixMarket path (``tests/COMMON/mmio.c`` + ``ssrcsr.c`` symmetric
to full expansion): load a ``.mtx`` file, expand symmetry, and pack it
into an :class:`~primme_tpu_torch.operators.ELLOperator` (or return the
scipy matrix).

A native C++ fast path for the parse and pack (large files) lives in
:mod:`primme_tpu_torch.native`; this module reads through scipy, which
needs no build.
"""

from __future__ import annotations

import numpy as np


def read_mtx(path: str, dense: bool = False):
    """Read a MatrixMarket file into a scipy CSR matrix (symmetry
    expanded, like the reference's ``ssrcsr``)."""
    import scipy.io as sio
    import scipy.sparse as sp

    A = sio.mmread(path)
    if sp.issparse(A):
        A = A.tocsr()
        return A.toarray() if dense else A
    return np.asarray(A)


def load_operator(path: str, device=None):
    """Load a ``.mtx`` file as an :class:`ELLOperator` (the reference
    driver's native CSR setup, ``tests/driver.c``) on ``device``: None
    means the card, and raises when there is none; ``"cpu"`` keeps it on
    the CPU."""
    from .operators import ELLOperator, default_device

    device = default_device(device, "load_operator")
    return ELLOperator.from_scipy(read_mtx(path)).to(device)
