"""uint32 lane arithmetic on torch int64 tensors.

The reference carries positions, anchors and bit-plane words as uint32.
torch's uint32 supports almost no arithmetic (`+`, `<`, `>>`, `~` raise), so
the port carries every u32 lane value as int64 in [0, 2^32) and re-applies
the 32-bit wrap (`wrap`) after each operation that can leave that range:
subtraction, `~`, left shifts and products.  Comparisons and sorts then run
on int64, where the 0xFFFFFFFF sentinel is the largest value, as it is as
u32.

The large index tables are stored as int32 holding the same bits (half the
memory of int64); `widen` restores the u32 value right after each gather.
Kernels take int32 bits; `to_i32` converts at that boundary with an explicit
wrap.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
INVALID = 0xFFFFFFFF          # u32 sentinel; sorts last among int64 lanes


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor modulo 2^32 (u32 wraparound)."""
    return x & MASK


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any int tensor) -> int64 u32 value in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values in [0, 2^32) -> int32 tensor holding the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def u32_to_i32_np(a: np.ndarray) -> np.ndarray:
    """Host uint32 array -> int32 array of the same bits (no copy)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def bnot(x: torch.Tensor) -> torch.Tensor:
    """Bitwise NOT of u32 lanes."""
    return x ^ MASK


def shl(x: torch.Tensor, n) -> torch.Tensor:
    """u32 left shift (bits shifted past bit 31 are dropped)."""
    return (x << n) & MASK


def mask_lt(nbits: torch.Tensor) -> torch.Tensor:
    """Lanes of bit counts (clipped to [0, 32]) -> mask of the lowest bits."""
    nb = nbits.to(torch.int64).clamp(0, 32)
    return (torch.ones_like(nb) << nb) - 1


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of u32 lanes (torch has no popcount op)."""
    v = x - ((x >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & MASK) >> 24
