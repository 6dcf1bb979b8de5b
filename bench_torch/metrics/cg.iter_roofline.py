"""The CG iteration's share of its memory roofline, in %: the bytes a
standard iteration must move (``cg_work.iter_bytes``: eleven passes over
the rank's vector; from the configuration, not the program's counters)
over the device's published HBM bandwidth, divided by the device time of
a ``cg_iter`` span."""

from bench_torch import cg_work, yardstick


def read(t):
    hbm = yardstick.peak(t.device_name, "hbm_bytes_per_s")
    ms = cg_work.per_iteration_ms(t, "cg_iter")
    if hbm is None or not ms:
        return None
    c = t.config
    nbytes = cg_work.iter_bytes(c["gdims"], c["pdims"],
                                cg_work.ITEMSIZE[c["dtype"]])
    return 100.0 * (nbytes / hbm) / (ms / 1e3)
