"""Single-end device mapping pipeline (counterpart of
bitmapperbs_tpu/models/aligner.py): convert -> seed -> locate -> dedup/cap
-> Hamming filter -> Myers verify -> order-free best/second selection.

Every stage is lane-parallel with masking over fixed shapes, and produces
the same (best, second) tuples as the reference.  u32 lanes are int64
(ops/u32.py).  `map_batch_device` enqueues its work and returns, so the
host loop can keep batches in flight, and copies no host data to the card
(`_constant`), so models/graphs.py can capture it in a CUDA graph.  The
compact path's flat buffer (ops/kernels.flat_expand, flat_dedup,
scatter_back; csrc/flat.cu on the card) keeps its fill counts n_used and
n_valid on the device, and locate and the gathering verify skip the lanes
past them there: what the reference's chunk loop (flat_chunks > 1) does,
at every flat_chunks and with no host read.

On a sharded index (index/device.upload_index_sharded) the same kernels
launch: the FM step kernels and the gathering verify read each row from
the shard that holds it (ops/kernels.py); the dense re-run's and the
mismatch-only path's windows go shard by shard (ops/kernels.gather_table).

Fixed capacities (AlignerConfig): S = num_seeds seeds per (pattern, block)
frame, O = max_seed_occ SA rows per seed, LB = locate_budget located rows
per frame, Kc = max_candidates verified anchors per frame.
"""
from __future__ import annotations

import torch

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.device import DeviceIndex
from bitmapperbs_tpu_torch.ops import fm, kernels, verify
from bitmapperbs_tpu_torch.ops.u32 import INVALID, wrap
from bitmapperbs_tpu_torch.oracle.pipeline import se_frames

INF = K.INF_SCORE
_I64 = torch.int64


_CONSTANTS: dict = {}


def _constant(values: tuple, dtype, dev) -> torch.Tensor:
    """A small constant tensor on `dev`, made once per (values, dtype,
    device) and kept: a call captured in a CUDA graph (models/graphs.py)
    cannot copy host data to the card, so it reads the copy that its
    warm-up made.  Read only."""
    key = (values, dtype, torch.device(dev))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=dev)
    return t


def _arange(n, dev):
    return torch.arange(n, dtype=_I64, device=dev)


def _revcomp_padded(reads, lengths):
    """Reverse-complement the real prefix of each padded read (pad -> N)."""
    B, m = reads.shape
    ar = _arange(m, reads.device)
    comp = torch.where(reads < 4, 3 - reads, reads)
    idxs = (lengths[:, None] - 1 - ar).clamp(0, m - 1)
    rc = torch.gather(comp, 1, idxs)
    return torch.where(ar[None, :] < lengths[:, None], rc, K.N_CODE).to(
        torch.uint8)


def _seed_bounds(lengths, num_seeds: int):
    """Pigeonhole slice [start, end) per seed, per read."""
    s = _arange(num_seeds, lengths.device)
    starts = (s[None, :] * lengths[:, None]) // num_seeds
    ends = ((s[None, :] + 1) * lengths[:, None]) // num_seeds
    return starts, ends


def _seed_stage(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                frames: tuple[tuple[int, int], ...], min_read_len: int = 0):
    """Shared convert + seed stages: frame tables and seed (sp, ep).
    min_read_len: host-known lower bound on the read lengths (0 = unknown);
    every pigeonhole slice is at least min_read_len // num_seeds long."""
    B, m = reads.shape
    S = cfg.num_seeds
    F = len(frames)
    dev = reads.device

    conv = _constant(tuple(K.CONV_MAP), torch.uint8, dev)
    rc = _revcomp_padded(reads, lengths)
    # se_frames(cfg, mate) lists the mate's own pattern first: frame 0 is
    # the read (mate 1) or its reverse complement (mate 2), frame 2 (PBAT)
    # the other one -- the layout paired._missing_mate_tables indexes
    frame_reads = torch.stack(
        [reads if p == K.PAT_CT else rc for p, _ in frames], dim=1)  # B,F,m
    patterns = conv[frame_reads.to(_I64)]                             # B,F,m
    blocks = _constant(tuple(b for _, b in frames), _I64, dev)
    bp_codes = _constant(tuple(b * 2 + p for p, b in frames), _I64, dev)

    # ---- seeding: backward-search every (read, frame, seed) ---------------
    starts, ends = _seed_bounds(lengths, S)              # B,S
    starts_l = starts[:, None, :].expand(B, F, S)
    ends_l = ends[:, None, :].expand(B, F, S)
    block_l = blocks[None, :, None].expand(B, F, S)
    pat_l = patterns[:, :, None, :].expand(B, F, S, m)
    max_seed_len = -(-m // S)
    end_kmers = None
    if dix.klt_k and max_seed_len > dix.klt_k:
        km = fm.rolling_kmers(patterns, dix.klt_k)            # B,F,m
        end_kmers = torch.gather(km, -1, (ends_l - 1).clamp(0, m - 1))
    sp, ep = fm.search_patterns(dix, block_l, pat_l, starts_l, ends_l,
                                max_len=max_seed_len, end_kmers=end_kmers,
                                min_len=min_read_len // S)
    if cfg.seed_ext_max:
        # adaptive extension: heavy seeds grow leftward until rare; starts
        # move with them so anchors (tp - start) stay exact
        sp, ep, starts_l = fm.extend_seeds(
            dix, block_l, pat_l, starts_l, sp, ep,
            cfg.seed_ext_max, cfg.seed_ext_occ)
    return frame_reads, blocks, bp_codes, starts_l, sp, ep


def order_seeds(sp, ep, starts, max_occ: int):
    """Per-frame seed reorder by ascending kept-occurrence count (stable by
    seed index), so locate-budget truncation drops the least informative
    seeds' entries first.  sp, ep: [..., S]; starts broadcastable to them.
    Returns (cnt, sp, start) in that order."""
    S = sp.shape[-1]
    cnt_u = wrap(ep - sp)
    seed_ok = (cnt_u > 0) & (cnt_u <= max_occ)
    cnt = torch.where(seed_ok, cnt_u, 0)
    order = torch.argsort(cnt * S + _arange(S, sp.device), dim=-1)
    return tuple(torch.gather(x, -1, order)
                 for x in (cnt, sp, starts.expand(sp.shape)))


def scatter_set(size: int, fill, dtype, dst, src):
    """1-D buffer of `size` filled with `fill`, src written at dst.  The
    last slot is the drop slot (dst == size - 1) and is cut off."""
    buf = torch.full((size,), fill, dtype=dtype, device=src.device)
    buf[dst.reshape(-1)] = src.reshape(-1).to(dtype)
    return buf[:-1]


def candidate_grids(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                    frames: tuple[tuple[int, int], ...],
                    min_read_len: int = 0):
    """The dense reference path (the spec): every stage over worst-case
    (B, F, budget) grids.  Returns (B, F, Kc) grids score (INF = invalid),
    fwd (fwd-genome anchor), frame_a (frame anchor), bp (block*2+pat), plus
    overflow/gdrop bool[B] and frame_reads.  The host's gdrop fallback."""
    B, m = reads.shape
    e = cfg.max_errors
    O = cfg.max_seed_occ
    LB = cfg.locate_budget
    Kc = cfg.max_candidates
    F = len(frames)
    Wd = m // 32
    L = dix.genome_len
    dev = reads.device

    frame_reads, blocks, bp_codes, starts_l, sp, ep = _seed_stage(
        dix, cfg, reads, lengths, frames, min_read_len)

    # ---- expansion into the locate grid (ascending-frequency seed order) --
    cnt, sp, starts_l = order_seeds(sp, ep, starts_l,
                                    cfg.max_seed_occ)            # B,F,S
    cs = torch.cumsum(cnt, dim=-1)
    offs = cs - cnt                                              # exclusive
    total = cs[..., -1]                                          # B,F
    ar_o = _arange(O, dev)
    slot = offs[..., None] + ar_o                                # B,F,S,O
    entry_ok = (ar_o < cnt[..., None]) & (slot < LB)
    sa_rows = wrap(sp[..., None] + ar_o)

    row_id = _arange(B, dev)[:, None] * F + _arange(F, dev)[None, :]
    flat_idx = torch.where(entry_ok, row_id[..., None, None] * LB + slot,
                           B * F * LB)                           # drop slot
    n_grid = B * F * LB + 1
    sa_grid = scatter_set(n_grid, 0, _I64, flat_idx, sa_rows)
    st_grid = scatter_set(n_grid, 0, _I64, flat_idx,
                          starts_l[..., None].expand(entry_ok.shape))
    ok_grid = scatter_set(n_grid, False, torch.bool, flat_idx, entry_ok)
    sa_grid, st_grid, ok_grid = (g.reshape(B, F, LB)
                                 for g in (sa_grid, st_grid, ok_grid))
    overflow = total > LB                                        # B,F

    # ---- locate + anchor projection ---------------------------------------
    block_lb = blocks[None, :, None].expand(B, F, LB)
    tp = fm.locate(dix, block_lb, sa_grid, ok_grid)              # B,F,LB
    anchor = wrap(tp - st_grid)
    n_lane = fm.block_n(dix, block_lb)
    a_ok = ok_grid & (tp >= st_grid) & (
        anchor <= wrap(n_lane - 1 - lengths[:, None, None]))
    anchor = torch.where(a_ok, anchor, INVALID)

    # ---- dedup (sort + unique) and cap at Kc ------------------------------
    srt = torch.sort(anchor, dim=-1).values                      # B,F,LB
    uniq = (srt != INVALID) & torch.cat(
        [torch.ones((B, F, 1), dtype=torch.bool, device=dev),
         srt[..., 1:] != srt[..., :-1]], dim=-1)
    csu = torch.cumsum(uniq.to(_I64), dim=-1)
    rank = csu - 1
    overflow = overflow | (csu[..., -1] > Kc)
    dst = torch.where(uniq & (rank < Kc), row_id[..., None] * Kc + rank,
                      B * F * Kc)
    cand = scatter_set(B * F * Kc + 1, INVALID, _I64, dst, srt).reshape(
        B, F, Kc)
    c_ok = cand != INVALID

    # ---- verification: Hamming filter then (optionally) Myers -------------
    read_planes = verify.pack_codes(frame_reads)                 # 3 x B,F,Wd
    lenmask = verify.length_mask(lengths, m)[:, None, None, :]   # B,1,1,Wd
    block_kc = blocks[None, :, None].expand(B, F, Kc)
    cand0 = torch.where(c_ok, cand, 0)
    ref_planes = verify.window_planes(dix.g_planes, block_kc, cand0, Wd, L,
                                      dix.g_words)
    rp = tuple(p[:, :, None, :] for p in read_planes)
    ham = verify.hamming(ref_planes, rp, lenmask)                # B,F,Kc

    if cfg.indels and e > 0:
        ncols = m + 2 * e
        Ww = -(-ncols // 32)
        win_planes = verify.window_planes(dix.g_planes, block_kc,
                                          wrap(cand0 - e), Ww, L, dix.g_words)
        peq, pad = verify.build_peq(frame_reads, lengths[:, None], m)
        med = kernels.myers(win_planes, peq[:, :, None], pad[:, :, None], m,
                            ncols)
        score = torch.where(ham <= e, ham, med)
    else:
        score = ham
    score = torch.where(c_ok & (score <= e), score, INF)         # B,F,Kc

    # ---- fwd-coordinate anchors -------------------------------------------
    fwd = torch.where(blocks[None, :, None] == K.BLOCK_FWD, cand,
                      wrap(L - cand - lengths[:, None, None]))
    valid = score < INF
    return {
        "score": score,
        "fwd": torch.where(valid, fwd, INVALID),
        "frame_a": torch.where(valid, cand, INVALID),
        "bp": bp_codes[None, :, None].expand(B, F, Kc),
        "overflow": overflow.any(dim=-1),
        "gdrop": torch.zeros(B, dtype=torch.bool, device=dev),
        "frame_reads": frame_reads,
    }


def candidate_grids_compact(dix: DeviceIndex, cfg: AlignerConfig, reads,
                            lengths, frames: tuple[tuple[int, int], ...],
                            min_read_len: int = 0):
    """candidate_grids over a flat buffer of occupied slots.

    The (read, frame, seed) occurrence lists are flattened batch-wide into
    CAP = B * flat_cap slots (kernels.flat_expand), located, deduped with
    one sort (kernels.flat_dedup), verified, and scattered back into the
    dense (B, F, Kc) grids (kernels.scatter_back).  Locate and the verify
    run only the lanes under the buffer's fill counts, which stay on the
    device.  Bit-identical to the dense path for every read whose frames
    fit the buffer; reads with dropped entries are flagged in `gdrop` for
    the host's dense re-run.
    """
    B, m = reads.shape
    e = cfg.max_errors
    LB = cfg.locate_budget
    Kc = cfg.max_candidates
    F = len(frames)
    Wd = m // 32
    L = dix.genome_len
    R = B * F
    CAP = B * cfg.resolve_flat_cap(L, F)
    frame_blocks = tuple(b for _, b in frames)

    frame_reads, _, bp_codes, starts_l, sp, ep = _seed_stage(
        dix, cfg, reads, lengths, frames, min_read_len)

    # ---- flat expansion: slot -> (frame, seed, offset) -------------------
    flat = kernels.flat_expand(sp, ep, starts_l, lengths, frame_blocks,
                               cfg.max_seed_occ, LB, CAP)
    ok, st, len_b, blk = (flat[k] for k in ("ok", "st", "len_b", "blk"))

    # ---- locate (the filled lanes) + anchor projection ---------------------
    tp = fm.locate(dix, blk, flat["sa_row"], ok, n_lanes=flat["n_used"])
    anchor = wrap(tp - st)
    a_ok = ok & (tp >= st) & (
        anchor <= wrap(fm.block_n(dix, blk) - 1 - len_b))
    anchor = torch.where(a_ok, anchor, INVALID)

    # ---- dedup: one sort on (row, anchor) + per-frame unique rank ----------
    # the reference's 2-key lax.sort as one stable sort of row << 32 | anchor
    key = (torch.where(a_ok, flat["fidx"], R) << 32) | anchor
    keyS, perm = torch.sort(key, stable=True)
    dd = kernels.flat_dedup(keyS, perm, len_b, flat["overflow"],
                            frame_blocks, Kc)

    # ---- verification on the flat (sorted, valid) lanes --------------------
    read_tab = torch.stack(verify.pack_codes(frame_reads), dim=2).reshape(
        R, 3 * Wd)                                # per frame: b0 | b1 | nmask
    blkS, cand, rowC, lenS = (dd[k] for k in ("blkS", "cand", "rowC",
                                              "lenS"))
    if cfg.indels and e > 0:
        # one kernel at every bucket width, on a whole or a sharded index:
        # window gather + funnel shifts + Hamming + PEQ + Myers
        score = kernels.verify_fused_gather(
            dix.g_planes, blkS, wrap(cand - e), read_tab, rowC, lenS, L,
            dix.g_words, m, m + 2 * e, e, n_lanes=dd["n_valid"])
    else:
        rp = read_tab[rowC]                                       # CAP,3*Wd
        rp = (rp[:, :Wd], rp[:, Wd:2 * Wd], rp[:, 2 * Wd:])
        ref = verify.window_planes(dix.g_planes, blkS, cand, Wd, L,
                                   dix.g_words)
        score = verify.hamming(ref, rp, verify.length_mask(lenS, m))

    # ---- scatter back into the dense (B, F, Kc) grids ----------------------
    grids = kernels.scatter_back(keyS, dd["keep"], dd["rank"], score,
                                 lengths, frame_blocks, L, e, Kc)
    return {
        **grids,
        "bp": bp_codes[None, :, None].expand(B, F, Kc),
        "overflow": dd["overflow"].any(dim=-1), "gdrop": flat["gdrop"],
        "frame_reads": frame_reads,
    }


def candidate_stage(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                    frames: tuple[tuple[int, int], ...],
                    min_read_len: int = 0):
    """Dispatch: compacted pipeline (default) or dense reference path."""
    fn = candidate_grids_compact if cfg.compact else candidate_grids
    return fn(dix, cfg, reads, lengths, frames, min_read_len)


def map_batch_device(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                     min_read_len: int = 0):
    """Single-end mapping: reads uint8[B, m_pad] (pad = N), lengths int[B],
    both on dix's device; min_read_len, when the caller knows it, is the
    shortest length in the batch (lets seeding skip its short-slice phase).
    Returns per-read tensors best_score (int32, INF when unmapped), best_bp
    (block*2+pat), best_anchor (u32 frame anchor as int64), second_score
    (int32, INF when no distinct-locus second), overflow and gdrop (bool;
    gdrop = host must re-run dense)."""
    grids = candidate_stage(dix, cfg, reads, lengths.to(_I64),
                            tuple(se_frames(cfg)), min_read_len)
    return kernels.select_se(grids, cfg.max_errors)
