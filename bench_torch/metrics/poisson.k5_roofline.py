"""K5's share of its memory roofline in a Poisson solve, in %: the bytes
its two transforms must move (``poisson_work.k5_bytes``: the half
spectrum read and written by each; from the configuration, not the
program's counters) over the device's published HBM bandwidth, divided by
the device time of the ``dft2`` spans a solve."""

from bench_torch import poisson_work, yardstick


def read(t):
    hbm = yardstick.peak(t.device_name, "hbm_bytes_per_s")
    ms = poisson_work.per_solve_ms(t, "dft2")
    if hbm is None or not ms:
        return None
    c = t.config
    nbytes = poisson_work.k5_bytes(c["gdims"], c["pdims"],
                                   poisson_work.COMPLEX_ITEMSIZE[c["dtype"]])
    return 100.0 * (nbytes / hbm) / (ms / 1e3)
