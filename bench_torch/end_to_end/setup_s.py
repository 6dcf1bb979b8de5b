"""Seconds from the start of the process that runs the benchmark to the
first timed iteration: imports, the program's build and load, plans,
inputs, warm-up."""


def read(w):
    return w.setup_s
