"""stencil3d_f64_roofline: the f64 stencil kernel's share of its roofline,
in percent: the least time of the traced launches (X read once and Y
written once at the card's published memory rate, or 8 operations a
point and column at its f64 rate, whichever is longer; shapes from the
harness's wrapper of the kernel entry) over the device time of the
kernels named stencil3d_kernel<double, ...>; moves solve_s."""

from lib import readers


def read(run):
    return readers.stencil_f64_roofline(run)
