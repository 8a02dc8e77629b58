"""pair_join_roofline (%): the summed bytes bound (at 3.35 TB/s) of the
pair_join launches of one eagerly mapped batch of the pool, over their summed
times, each launch timed alone in a CUDA graph of 20 (roofline.py).
Layer kernels: ops/kernels.py and csrc/."""


def read(t):
    r = (t["roofline"] or {}).get("pair_join")
    if not r or not r["ms"]:
        return None
    return 100.0 * r["bound_ms"] / r["ms"]
