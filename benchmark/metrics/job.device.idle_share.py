"""job.device.idle_share: device.idle_share in the whole-job cell, where it
moves job_s."""

from lib import readers


def read(run):
    return readers.idle_share(run)
