"""Device mesh (counterpart of bitmapperbs_tpu/parallel/mesh.py).

The parallel axis is 'data': a batch of reads is split into equal row
slices, one per row of the mesh.  Each row is an index group: one card that
holds the whole index (replicated index, mesh axes ('data',)), or the cards
over which the index's big tables are split (sharded index, axes
('data', 'idx')).  A mesh is a grid of torch devices in which a device may
appear more than once: the CPU tests map on eight "devices" that are all
the CPU, and one card can stand for a whole host's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[i][j]: card j of data slice i's index group."""
    devices: tuple[tuple[torch.device, ...], ...]
    axes: tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict[str, int]:
        sizes = (len(self.devices), len(self.devices[0]))
        return dict(zip(self.axes, sizes))

    @classmethod
    def grid(cls, devices, data: int, idx: int | None = None) -> "Mesh":
        """The first data * idx devices, row by row: axes ('data', 'idx'),
        or ('data',) with one device per row when idx is None."""
        devices = [torch.device(d) for d in devices]
        n = data * (idx or 1)
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        rows = tuple(tuple(devices[i * n // data:(i + 1) * n // data])
                     for i in range(data))
        return cls(rows, ("data",) if idx is None else ("data", "idx"))


def local_devices() -> list[torch.device]:
    """Every CUDA device this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_batch(mesh: Mesh, reads, lengths) -> list[tuple]:
    """A (B, m) read batch and its lengths (numpy arrays or tensors) ->
    `data` equal row slices, slice i on its index group's first card."""
    data = len(mesh.devices)
    B = reads.shape[0]
    if B % data:
        raise ValueError(f"batch of {B} rows does not split into {data} "
                         f"data slices")
    step = B // data

    def put(x, lo, dev):
        part = x[lo:lo + step]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(dev)

    return [(put(reads, i * step, row[0]), put(lengths, i * step, row[0]))
            for i, row in enumerate(mesh.devices)]
