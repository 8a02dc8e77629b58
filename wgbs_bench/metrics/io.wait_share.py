"""io.wait_share (%): the main thread's time blocked on the reader's
Prefetcher (span `input`) and in SamWriter.write (span `write`), over the
window less its profiled stretch (`spans_s`).  Layer io: io/fastq.py,
io/sam.py."""


def read(t):
    s = t["spans"]
    if "input" not in s:
        return None
    return 100.0 * (s["input"] + s.get("write", 0.0)) / t["spans_s"]
