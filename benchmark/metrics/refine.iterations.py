"""refine.iterations: LOBPCG steps of the f64 polish (refine_eigsh's
num_refine_iters), mean over the traced calls; moves solve_s."""

from lib import readers


def read(run):
    return readers.mean_counter(run, "refine_iters")
