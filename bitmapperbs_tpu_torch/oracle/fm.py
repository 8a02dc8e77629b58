"""Obviously-correct naive FM-index oracle (SURVEY.md section 4 item 1/2).

Used only in tests, on tiny texts: full O(n x alphabet) occ matrix, brute-force
pattern counting, full SA for locate.  The packed runtime (index/packed.py) and
the device kernels (ops/) are verified against this.
"""
from __future__ import annotations

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.index import sais


class NaiveFM:
    def __init__(self, conv_text: np.ndarray):
        text = np.concatenate([
            np.asarray(conv_text, dtype=np.uint8), np.zeros(1, np.uint8)])
        self.text = text
        self.n = len(text)
        self.sa = sais.suffix_array_numpy(text)
        self.bwt = text[(self.sa - 1) % self.n]
        # occ_matrix[i, c] = count of c in bwt[0:i)
        onehot = self.bwt[:, None] == np.arange(K.CONV_ALPHA)[None, :]
        self.occ_matrix = np.zeros((self.n + 1, K.CONV_ALPHA), dtype=np.int64)
        self.occ_matrix[1:] = np.cumsum(onehot, axis=0)
        hist = np.bincount(text, minlength=K.CONV_ALPHA)
        self.cbase = np.concatenate([[0], np.cumsum(hist)[:-1]])

    def occ(self, c: int, i: int) -> int:
        return int(self.occ_matrix[i, c])

    def extend_backward(self, sp: int, ep: int, c: int):
        return (self.cbase[c] + self.occ(c, sp), self.cbase[c] + self.occ(c, ep))

    def count(self, pattern: np.ndarray):
        sp, ep = 0, self.n
        for c in pattern[::-1]:
            sp, ep = self.extend_backward(sp, ep, int(c))
            if sp >= ep:
                break
        return sp, ep

    def count_bruteforce(self, pattern: np.ndarray) -> int:
        """Direct text scan -- independent of all FM machinery."""
        p = np.asarray(pattern, dtype=np.uint8)
        m, n = len(p), self.n
        if m == 0 or m > n:
            return max(n - m + 1, 0) if m == 0 else 0
        windows = np.lib.stride_tricks.sliding_window_view(self.text, m)
        return int((windows == p).all(axis=1).sum())

    def locate(self, i) -> np.ndarray:
        return self.sa[np.asarray(i, dtype=np.int64)]
