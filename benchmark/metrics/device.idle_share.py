"""device.idle_share: percent of the traced window (the first traced call's
start to the last one's end) in which no kernel, copy or set ran on the
card; moves solve_s."""

from lib import readers


def read(run):
    return readers.idle_share(run)
