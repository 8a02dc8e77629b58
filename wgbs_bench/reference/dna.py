"""Host-side DNA utilities: encoding, complement, bisulfite conversion.

All functions are vectorized numpy over uint8 code arrays (A=0,C=1,G=2,T=3,
N=4 -- see bitmapperbs_tpu_torch.constants).  These define the semantics the oracle
and the device pipeline must both follow.
"""
from __future__ import annotations

import numpy as np

from wgbs_bench.reference import constants as K

_ENC = np.full(256, K.N_CODE, dtype=np.uint8)
for i, ch in enumerate(K.BASE_CHARS):
    _ENC[ord(ch)] = i
    _ENC[ord(ch.lower())] = i

_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)

_CONV = np.array(K.CONV_MAP, dtype=np.uint8)  # original(5) -> converted(4)

# complement: A<->T, C<->G, N->N
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (N=4 for anything non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENC[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _DEC[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def complement(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes][::-1]


def ct_convert(codes: np.ndarray) -> np.ndarray:
    """Original codes -> converted 3-letter FM codes ($AGT space, C->T, N->A)."""
    return _CONV[codes]
