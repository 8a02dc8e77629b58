"""The scoring of candidates: asymmetric matching, Hamming, semi-global edit
distance (the configurations' stated verify; the records' alignment is
worked out apart, in finalize.py).

Everything here is plain numpy / Python on ORIGINAL-space codes *in the
alignment frame* (the frame where the pattern matched forward; block 1 uses
rc(W) codes).  The asymmetric bisulfite rule in-frame is always:

    match(ref, read) = (ref == read) or (ref == C and read == T)
    N (code 4) on either side never matches.

Frozen spec decisions (SURVEY.md section 7 "freeze in Phase 0"):
- Verification is semi-global: the read aligns end-to-end, the reference
  window [anchor-e, anchor+m+e) is local (free start/end columns).
- Candidate score = d_ham if d_ham <= e else d_edit (SURVEY.md call stack 3.4
  "accept-as-is" fast path; d_edit <= d_ham always, so this only ever
  over-reports by a bounded amount, identically in oracle and device).
"""
from __future__ import annotations

import numpy as np

from wgbs_bench.reference import constants as K


def asym_match(ref: np.ndarray, read: np.ndarray, ga: bool = False) -> np.ndarray:
    """Elementwise bisulfite-asymmetric match.

    In the alignment frame the rule is always CT (`ga=False`); `ga=True`
    is ref G =~ read A.
    """
    ref = np.asarray(ref)
    read = np.asarray(read)
    eq = ref == read
    if ga:
        bs = (ref == K.G) & (read == K.A)
    else:
        bs = (ref == K.C) & (read == K.T)
    valid = (ref != K.N_CODE) & (read != K.N_CODE)
    return (eq | bs) & valid


def hamming(ref: np.ndarray, read: np.ndarray) -> int:
    """Asymmetric mismatch count over equal-length in-frame sequences."""
    return int((~asym_match(ref, read)).sum())


def edit_matrix(window: np.ndarray, read: np.ndarray) -> np.ndarray:
    """Full semi-global DP matrix D[i, j]: read[0:i] vs window ending at j.

    D[0, j] = 0 (free start anywhere in window); D[i, 0] = i.

    Row-vectorized with the exact prefix-min identity: with
    t[j] = min(D[i-1, j-1] + sub, D[i-1, j] + 1) and t[0] = D[i, 0] = i,
    unrolling the left-neighbor dependency gives
    D[i, j] = min_{k <= j} (t[k] + (j - k)), i.e. a running minimum of
    t[k] - k -- bit-identical to the naive three-way recurrence (pinned by
    tests/test_oracle_pipeline.py::test_edit_matrix_matches_naive), ~100x
    faster, which is what makes >=500-read oracle differentials at 3 Gbp
    tractable."""
    m, w = len(read), len(window)
    match = asym_match(window[None, :], read[:, None])  # [m, w]
    D = np.zeros((m + 1, w + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    jr = np.arange(w + 1, dtype=np.int32)
    t = np.empty(w + 1, dtype=np.int32)
    for i in range(1, m + 1):
        prev = D[i - 1]
        t[0] = i
        np.minimum(prev[:-1] + (match[i - 1] == 0), prev[1:] + 1,
                   out=t[1:], dtype=np.int32, casting="unsafe")
        np.minimum.accumulate(t - jr, out=t)
        D[i] = t + jr
    return D


def edit_distance(window: np.ndarray, read: np.ndarray) -> int:
    """min over end columns of the semi-global DP (the Myers kernel's value)."""
    return int(edit_matrix(window, read)[len(read)].min())


def edit_distances(windows: np.ndarray, read: np.ndarray,
                   cap: int) -> np.ndarray:
    """edit_distance(windows[k], read) of each row; a row whose distance is
    over cap may read as any value over cap.  The rows share edit_matrix's
    row recurrence; a row leaves once its row minimum passes cap, since the
    minimum of a DP row never falls from one row to the next."""
    k, w = windows.shape
    m = len(read)
    match = asym_match(windows[:, None, :], read[None, :, None])  # [k, m, w]
    out = np.full(k, cap + 1, dtype=np.int64)
    live = np.arange(k)
    D = np.zeros((k, w + 1), dtype=np.int32)
    jr = np.arange(w + 1, dtype=np.int32)
    for i in range(1, m + 1):
        t = np.empty_like(D)
        t[:, 0] = i
        np.minimum(D[:, :-1] + (match[live, i - 1] == 0), D[:, 1:] + 1,
                   out=t[:, 1:], dtype=np.int32, casting="unsafe")
        np.minimum.accumulate(t - jr, axis=1, out=t)
        D = t + jr
        keep = D.min(1) <= cap
        if not keep.all():
            live, D = live[keep], D[keep]
            if not len(live):
                return out
    out[live] = D.min(1)
    return out
