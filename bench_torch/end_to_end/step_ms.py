"""Milliseconds per solver step: the whole window over the steps
completed in it."""


def read(w):
    if not w.work.get("steps") or not w.iterations:
        return None
    return w.seconds / w.iterations * 1e3
