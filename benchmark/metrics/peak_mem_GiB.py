"""peak_mem_GiB: the card's ``max_memory_allocated()`` over the window,
reset at its start, in GiB: device memory caps the ``n`` a user can solve
on one card."""


def read(run):
    return run["peak_bytes"] / 2 ** 30 if run["peak_bytes"] else None
