"""device.idle_share: 1 - the union of the device operations' intervals over
the traced steps' window, from torch.profiler's CUDA activity."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
