"""device.idle_share (%): 1 - busy / wall over the traced sub-window, the
card's busy time being the union of its operations in torch.profiler's
trace.  Layer device."""


def read(t):
    p = t["profile"]
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
