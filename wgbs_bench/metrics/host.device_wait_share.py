"""host.device_wait_share (%): the main thread's time in
models.host.to_host (span `to_host`: the one device-to-host copy of a
batch, which waits on the card), over the window less its profiled stretch
(`spans_s`).  Layer host loop: models/host.py, models/pool.py."""


def read(t):
    if "to_host" not in t["spans"]:
        return None
    return 100.0 * t["spans"]["to_host"] / t["spans_s"]
