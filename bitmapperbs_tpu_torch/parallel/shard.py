"""Mapping over a device mesh (counterpart of
bitmapperbs_tpu/parallel/shard.py).

Two modes, as the reference's:
- replicated index (default): mesh ('data',), one whole DeviceIndex per
  card; a batch is split into one row slice per card.
- sharded index: mesh ('data', 'idx'); each data slice's index group holds
  cp_rows / sa_samples / g_planes split into row ranges over its cards
  (index/device.upload_index_sharded).  The lanes live on the group's first
  card, and the fused kernels launched there (FM steps, gathering verify,
  mate rescue: the same launches as one card) read each row from the shard
  that holds it, through peer access on the other cards of the group; the
  dense re-run's and the mismatch-only windows take one
  kernels.gather_rows_shard per shard, the partial rows summed on the
  lanes' card (ops/kernels.gather_table), where the reference psums.  A
  group whose cards lack peer access is refused when the index is placed.

The slices are dispatched in turn from the calling thread with no host sync
between them (kernel launches are asynchronous, so distinct cards overlap
wherever the path does not sync), and their outputs are concatenated in
order on the first slice's card.  Both modes give the single-device
pipeline's outputs exactly (order-free selection; gdrop re-runs merged per
read), which tests/test_torch_shard.py holds to the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.build import BSIndex
from bitmapperbs_tpu_torch.index.device import (DeviceIndex, Shards,
                                                upload_index,
                                                upload_index_sharded)
from bitmapperbs_tpu_torch.models.aligner import map_batch_device
from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
from bitmapperbs_tpu_torch.ops import kernels
from bitmapperbs_tpu_torch.parallel.mesh import Mesh, local_devices, \
    shard_batch


def _place(dix: DeviceIndex, group) -> DeviceIndex:
    """dix's tables on another index group: the whole tables on its first
    card, shard s on its card s (no copy where a device is the same).  The
    first card's kernels read the others' shards: peer access is enabled
    first, and refused pairs raise (ops/kernels.enable_peer_access)."""
    if dix.sharded:
        kernels.enable_peer_access(group[0], group[1:])

    def move(t):
        if isinstance(t, Shards):
            return Shards(tuple(p.to(d) for p, d in zip(t.parts, group)))
        return t.to(group[0])

    return dataclasses.replace(dix, **{
        f.name: move(getattr(dix, f.name))
        for f in dataclasses.fields(dix)
        if isinstance(getattr(dix, f.name), (torch.Tensor, Shards))})


def upload_mesh_index(idx: BSIndex, mesh: Mesh) -> tuple[DeviceIndex, ...]:
    """One DeviceIndex per data slice: the index uploaded once (sharded
    over the first index group when the mesh has an 'idx' axis) and copied
    card to card to the other groups."""
    first = mesh.devices[0]
    dix = (upload_index_sharded(idx, first) if "idx" in mesh.axes
           else upload_index(idx, first[0]))
    return tuple(_place(dix, group) for group in mesh.devices)


def _concat(outs: list[dict], device) -> dict:
    """Per-slice output dicts (nested dicts allowed) -> one, rows in slice
    order, on `device`."""
    if len(outs) == 1:
        return outs[0]
    return {k: _concat([o[k] for o in outs], device)
            if isinstance(v, dict)
            else torch.cat([o[k].to(device) for o in outs])
            for k, v in outs[0].items()}


def make_sharded_se_mapper(cfg: AlignerConfig, mesh: Mesh, dix):
    """fn(reads, lengths, min_read_len=0) -> map_batch_device's output
    dict for the whole batch; dix: one DeviceIndex per data slice
    (upload_mesh_index).  min_read_len: the batch's shortest read length
    when the caller knows it (a hint, as in map_batch_device)."""
    def fn(reads, lengths, min_read_len: int = 0):
        outs = [map_batch_device(d, cfg, r, ln, min_read_len=min_read_len)
                for d, (r, ln) in zip(dix, shard_batch(mesh, reads, lengths))]
        return _concat(outs, mesh.devices[0][0])
    return fn


def make_sharded_pe_mapper(cfg: AlignerConfig, mesh: Mesh, dix):
    """Paired-end analogue: fn(reads1, lengths1, reads2, lengths2,
    min_read_len1=0, min_read_len2=0) -> map_batch_pe_device's output dict
    (se1 / se2 nested) for the whole batch."""
    def fn(r1, l1, r2, l2, min_read_len1: int = 0, min_read_len2: int = 0):
        outs = [map_batch_pe_device(d, cfg, a1, b1, a2, b2,
                                    min_read_len1=min_read_len1,
                                    min_read_len2=min_read_len2)
                for d, (a1, b1), (a2, b2) in zip(
                    dix, shard_batch(mesh, r1, l1), shard_batch(mesh, r2, l2))]
        return _concat(outs, mesh.devices[0][0])
    return fn


@dataclasses.dataclass
class CliMappers:
    """Multi-device mapping entry points for the CLI: models/host.py calls
    `se` / `pe` in place of the single-device pipeline (on host arrays, a
    batch whose rows are a multiple of batch_round), and `se_dense` /
    `pe_dense`, the compact-off mappers, for the per-read gdrop re-run.
    dix: one DeviceIndex per data slice."""

    mesh: Mesh
    dix: tuple[DeviceIndex, ...]
    batch_round: int
    se: object = None
    se_dense: object = None
    pe: object = None
    pe_dense: object = None


def make_cli_mappers(idx: BSIndex, cfg: AlignerConfig, devices=None,
                     shard_index: int = 0,
                     reuse: CliMappers | None = None) -> CliMappers:
    """The CLI's mappers over the local devices.

    devices: torch devices (default: every local CUDA device; a device may
    repeat).  shard_index: if > 0, split the index's big tables over an
    'idx' axis of this size (for an index larger than one card's memory);
    the data axis gets len(devices) // shard_index slices.  0: replicated.
    reuse: an existing CliMappers whose mesh and uploaded index are reused;
    only the mappers are rebuilt for the new cfg (the CLI's -e RATE groups
    and grown length buckets do not upload the index again)."""
    if reuse is not None:
        mesh, dix, data = reuse.mesh, reuse.dix, reuse.batch_round
    else:
        devices = local_devices() if devices is None else list(devices)
        ndev = len(devices)
        if shard_index:
            if ndev % shard_index:
                raise ValueError(f"--shard-index {shard_index} does not "
                                 f"divide device count {ndev}")
            data = ndev // shard_index
            mesh = Mesh.grid(devices, data, shard_index)
        else:
            data = ndev
            mesh = Mesh.grid(devices, data)
        dix = upload_mesh_index(idx, mesh)

    out = CliMappers(mesh=mesh, dix=dix, batch_round=data)
    if cfg.paired:
        out.pe = make_sharded_pe_mapper(cfg, mesh, dix)
        out.pe_dense = make_sharded_pe_mapper(cfg.replace(compact=False),
                                              mesh, dix)
    else:
        out.se = make_sharded_se_mapper(cfg, mesh, dix)
        out.se_dense = make_sharded_se_mapper(cfg.replace(compact=False),
                                              mesh, dix)
    return out
