"""Seconds from the process's start to the window's first request: imports,
the weights, the service and its warm-up (and, in a fresh checkout, the
kernel library's build)."""


def read(run):
    return run.setup_s
