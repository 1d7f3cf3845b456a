"""job.refine.idle_ms: refine.idle_ms in the whole-job cell, where it
moves job_s."""

from lib import spans


def read(run):
    return spans.idle_ms(run, "pt_refine")
