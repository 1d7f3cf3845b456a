"""job.refine.iterations: refine.iterations in the whole-job cell, where
it moves job_s."""

from lib import readers


def read(run):
    return readers.mean_counter(run, "refine_iters")
