"""job.stencil3d_f64_roofline: stencil3d_f64_roofline in the whole-job
cell, where it moves job_s."""

from lib import readers


def read(run):
    return readers.stencil_f64_roofline(run)
