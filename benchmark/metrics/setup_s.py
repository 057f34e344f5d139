"""Seconds from the start of the process to the first timed frame: imports,
the kernel library's load (its build in a fresh checkout), the scene build
and ingest, and the warm-up frames."""


def read(window):
    return window.setup_s
