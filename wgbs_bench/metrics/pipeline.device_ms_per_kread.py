"""pipeline.device_ms_per_kread (ms/kread): the card's busy time (the union
of its operations in torch.profiler's trace of a sub-window of the measured
window) per 1,000 reads whose calls ran in that sub-window.  Layer
pipeline: models/aligner.py, models/paired.py, models/graphs.py."""


def read(t):
    p = t["profile"]
    if not p or not p["busy_s"] or not t["sub_reads"]:
        return None
    return p["busy_s"] * 1e3 / (t["sub_reads"] / 1e3)
