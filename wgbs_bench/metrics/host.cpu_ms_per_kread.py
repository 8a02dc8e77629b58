"""host.cpu_ms_per_kread (ms/kread): user + system CPU seconds of the run's
process and its finalize workers (/proc/<pid>/stat) over the window less
its profiled stretch (`cpu_s`), per 1,000 reads the window mapped outside
that stretch (`cpu_reads`).  A card shares its host's cores: a rate bought
with more of them shows here.  Layer host loop: models/host.py,
models/pool.py, io."""


def read(t):
    if not t.get("cpu_reads") or t.get("cpu_s", 0) <= 0:
        return None
    return t["cpu_s"] * 1e3 / (t["cpu_reads"] / 1e3)
