"""The stencil pass's share of its memory roofline, in %: the bytes a step
must move (``stencil_work.step_bytes``: the field read once and written
once, and any ghost planes of a split dim; from the configuration, not
the program's counters) over the device's published HBM bandwidth,
divided by ``heat.stencil_ms``.  Where the program's passes count their
bytes, the count must be that same work: a pass that counts other bytes
ran another step than the configuration's, and the share reads nothing."""

from bench_torch import stencil_work, yardstick


def read(t):
    hbm = yardstick.peak(t.device_name, "hbm_bytes_per_s")
    ms = stencil_work.pass_ms(t)
    if hbm is None or not ms:
        return None
    c = t.config
    nbytes = stencil_work.step_bytes(c["gdims"], c["pdims"],
                                     stencil_work.ITEMSIZE[c["dtype"]])
    counted = stencil_work.pass_bytes(t)
    if counted is not None and counted != nbytes:
        return None
    return 100.0 * (nbytes / hbm) / (ms / 1e3)
