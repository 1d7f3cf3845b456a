"""solver.idle_ms: milliseconds a traced call in which the card ran
nothing while the program was inside its pt_eigsh span (the f32 stage,
entry to numpy results): the host-paced part of the job; moves job_s."""

from lib import spans


def read(run):
    return spans.idle_ms(run, "pt_eigsh")
