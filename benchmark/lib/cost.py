"""Peaks of the card and the work a kernel launch needs.

``PEAKS`` holds the published figures of each card by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's H100 data sheet, SXM5
part, dense rates at the full 700 W (HBM3 3.35 TB/s; FP64 34 TFLOP/s on
the CUDA cores, 67 on the tensor cores; FP32 67 TFLOP/s). A card that is
not in the table has no roofline here.

The 7-point stencil's launch on an ``[n, k]`` block needs X read once and
Y written once, ``2 n k`` elements (the six neighbours come again from the
caches, so they are not counted), and 8 operations a point and column:
``6 x``, six subtractions and the scale. The least time of a launch is
the longer of its bytes at the memory's rate and its operations at the
compute peak of its type on the CUDA cores, where it runs.
"""

from __future__ import annotations

H100_SXM = {"hbm_bytes_per_s": 3.35e12,
            "flops_per_s": {"float64": 34e12, "float32": 67e12}}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def stencil7_bytes(n: int, k: int, itemsize: int) -> int:
    """Bytes one product of an ``[n, k]`` block needs: X once, Y once."""
    return 2 * n * k * itemsize


def stencil7_flops(n: int, k: int) -> int:
    """Operations of one product: 8 a point and column."""
    return 8 * n * k


def least_seconds(nbytes: float, flops: float, peak: dict,
                  dtype: str) -> tuple:
    """``(seconds, "bytes" | "flops")``: the longer of the two bounds and
    which one it is."""
    tb = nbytes / peak["hbm_bytes_per_s"]
    tf = flops / peak["flops_per_s"][dtype]
    return (tb, "bytes") if tb >= tf else (tf, "flops")


def stencil7_roofline(launches, kernel_seconds: float, peak: dict,
                      dtype: str):
    """``(share in %, bound)`` of the stencil launches ``[(n, k,
    itemsize), ...]`` that took ``kernel_seconds`` of device time in all:
    their summed least time over that time. None where there is nothing
    to read."""
    if not launches or kernel_seconds <= 0 or peak is None:
        return None
    least, by = 0.0, {}
    for n, k, size in launches:
        t, b = least_seconds(stencil7_bytes(n, k, size),
                             stencil7_flops(n, k), peak, dtype)
        least += t
        by[b] = by.get(b, 0.0) + t
    bound = max(by, key=by.get)
    return 100.0 * least / kernel_seconds, bound
