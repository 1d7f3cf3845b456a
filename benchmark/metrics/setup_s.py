"""setup_s: seconds from the process's start to the first timed call:
imports, operators, the job's inputs and warm calls, and in a checkout's
first run the program's kernel builds."""


def read(run):
    return run["setup_s"]
