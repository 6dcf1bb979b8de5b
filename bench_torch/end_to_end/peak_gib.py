"""The peak of ``torch.cuda.max_memory_allocated`` over set-up and the
window, in GiB (2**30 bytes)."""


def read(w):
    if not w.peak_bytes:
        return None
    return w.peak_bytes / 2 ** 30
