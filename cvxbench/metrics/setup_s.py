"""setup_s: from the process's start (its start time in /proc) to the
first timed step: imports, the kernels' load (or build, in a checkout's
first run), canonicalisation and the warm steps."""


def read(run):
    return run.setup_s
