"""refine.host_reads: the program's pt_read spans inside its pt_refine
span, a traced call (two a LOBPCG step: the convergence test's read and
eigh's check; equals refine_eigsh's stats["num_host_reads"]); moves
solve_s."""

from lib import spans


def read(run):
    return spans.count_in(run, "pt_read", "pt_refine")
