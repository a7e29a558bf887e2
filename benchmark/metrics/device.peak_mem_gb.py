"""device.peak_mem_gb: torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats() at its start."""


def read(rec):
    b = rec.get("window_peak_bytes")
    return None if not b else b / 1e9
