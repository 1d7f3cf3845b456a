"""inner.idle_ms: milliseconds a traced call in which the card ran nothing
while the program was inside a pt_inner span (core/inner.py's QMR inner
solves, one a host read a step); moves job_s."""

from lib import spans


def read(run):
    return spans.idle_ms(run, "pt_inner")
