"""solver.matvecs: operator columns applied by the f32 stage (eigsh's
stats["num_matvecs"], the spectrum probe's included), mean over the
traced calls; moves job_s."""

from lib import readers


def read(run):
    return readers.mean_counter(run, "matvecs")
