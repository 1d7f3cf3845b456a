"""refine.polish_s: seconds of the benchmark's span around refine_eigsh
on the host clock (the entry returns numpy, so the span ends after the
card has finished), mean over the traced calls; moves job_s."""

from lib import readers


def read(run):
    return readers.mean_counter(run, "polish_s")
