"""``torch.cuda.max_memory_allocated()`` over the window (reset after the
warm-up), in 10^9 bytes."""
UNIT = "GB"


def read(run):
    return None if run.device_peak_bytes is None else run.device_peak_bytes / 1e9
