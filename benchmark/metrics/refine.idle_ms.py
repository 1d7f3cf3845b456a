"""refine.idle_ms: milliseconds a traced call in which the card ran
nothing while the program was inside its pt_refine span (refine_eigsh,
entry to numpy results); moves solve_s."""

from lib import spans


def read(run):
    return spans.idle_ms(run, "pt_refine")
