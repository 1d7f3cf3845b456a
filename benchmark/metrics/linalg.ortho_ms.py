"""linalg.ortho_ms: device milliseconds a call under the program's
pt_ortho scope (core/linalg.py; it opens only while a profiler records),
over the traced calls; moves job_s."""

from lib import readers


def read(run):
    return readers.scope_ms(run, "pt_ortho")
