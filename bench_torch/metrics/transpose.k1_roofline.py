"""K1's share of its memory roofline, in %: the bytes the round trip's
slab transposes must move (each reads and writes this rank's field once;
``yardstick.transpose_bytes_per_round_trip``) over the device's published
HBM bandwidth, divided by K1's device time per round trip.  The bytes
count the transposes' work, not K1's launches."""

from bench_torch import yardstick
from bench_torch.trace import is_k1

ITEMSIZE = {"complex64": 8, "complex128": 16, "float32": 4, "float64": 8}


def read(t):
    k1_s = t.trace.ms(is_k1) / t.iterations / 1e3
    hbm = yardstick.peak(t.device_name, "hbm_bytes_per_s")
    if k1_s <= 0 or hbm is None:
        return None
    c = t.config
    nbytes = yardstick.transpose_bytes_per_round_trip(
        c["gdims"], c["pdims"], ITEMSIZE[c["dtype"]],
        t.traffic["layout"] == "axis_contiguous")
    return 100.0 * (nbytes / hbm) / k1_s
