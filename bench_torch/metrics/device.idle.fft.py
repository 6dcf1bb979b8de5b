"""The device's idle share of the traced window of round trips, in %."""


def read(t):
    if t.trace.window_us <= 0 or not t.trace.ops:
        return None
    return 100.0 * (1.0 - t.trace.busy_us() / t.trace.window_us)
