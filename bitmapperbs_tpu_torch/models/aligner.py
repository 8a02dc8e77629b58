"""Single-end device mapping pipeline (counterpart of
bitmapperbs_tpu/models/aligner.py): convert -> seed -> locate -> dedup/cap
-> Hamming filter -> Myers verify -> order-free best/second selection.

Every stage is lane-parallel with masking over fixed shapes, and produces
the same (best, second) tuples as the reference.  u32 lanes are int64
(ops/u32.py).  The only host sync is in `_chunked_lanes` (flat_chunks > 1);
otherwise `map_batch_device` enqueues its work and returns, so the host
loop can keep batches in flight, and copies no host data to the card
(`_constant`), so models/graphs.py can capture it in a CUDA graph.

On a sharded index (index/device.upload_index_sharded) the same kernels
launch: the FM step kernels and the gathering verify read each row from
the shard that holds it (ops/kernels.py); the dense re-run's and the
mismatch-only path's windows go shard by shard (ops/kernels.gather_table),
and flat_chunks is off, as in the reference.

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
from bitmapperbs_tpu_torch.ops.u32 import INVALID, MASK, wrap
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


def _order_seeds(cfg: AlignerConfig, sp, ep, starts_l):
    """Per-frame seed reorder by ascending kept-occurrence count (stable by
    seed index), so locate-budget truncation drops the least informative
    seeds' entries first.  Returns (cnt, sp, start) in that order."""
    S = sp.shape[-1]
    cnt_u = wrap(ep - sp)
    seed_ok = (cnt_u > 0) & (cnt_u <= cfg.max_seed_occ)
    cnt = torch.where(seed_ok, cnt_u, 0)
    order = torch.argsort(cnt * S + _arange(S, sp.device), dim=-1)
    return tuple(torch.gather(x, -1, order) for x in (cnt, sp, starts_l))


def _scatter_set(size: int, fill, dtype, dst, src):
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
    cnt, sp, starts_l = _order_seeds(cfg, sp, ep, starts_l)      # B,F,S
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
    sa_grid = _scatter_set(n_grid, 0, _I64, flat_idx, sa_rows)
    st_grid = _scatter_set(n_grid, 0, _I64, flat_idx,
                           starts_l[..., None].expand(entry_ok.shape))
    ok_grid = _scatter_set(n_grid, False, torch.bool, flat_idx, entry_ok)
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
    cand = _scatter_set(B * F * Kc + 1, INVALID, _I64, dst, srt).reshape(
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


def _chunked_lanes(nchunks: int, n_used, outs_init, args, fn):
    """Run per-lane `fn` over flat-buffer chunks, skipping whole chunks past
    the last occupied slot `n_used`.  Lanes never visited keep their
    outs_init values (callers already mask them).

    Reads n_used on the host: one device sync per call."""
    CAP = args[0].shape[0]
    C = -(-CAP // nchunks)
    n = int(n_used)
    outs = tuple(o.clone() for o in outs_init)
    for lo in range(0, min(n, CAP), C):
        res = fn(*(a[lo:lo + C] for a in args))
        for o, r in zip(outs, res):
            o[lo:lo + C] = r
    return outs


def candidate_grids_compact(dix: DeviceIndex, cfg: AlignerConfig, reads,
                            lengths, frames: tuple[tuple[int, int], ...],
                            min_read_len: int = 0):
    """candidate_grids over a flat buffer of occupied slots.

    The (read, frame, seed) occurrence lists are flattened batch-wide into
    CAP = B * flat_cap slots, located, deduped with one sort, verified, and
    scattered back into the dense (B, F, Kc) grids.  Bit-identical to the
    dense path for every read whose frames fit the buffer; reads with
    dropped entries are flagged in `gdrop` for the host's dense re-run.
    """
    B, m = reads.shape
    e = cfg.max_errors
    S = cfg.num_seeds
    LB = cfg.locate_budget
    Kc = cfg.max_candidates
    F = len(frames)
    Wd = m // 32
    L = dix.genome_len
    R = B * F
    CAP = B * cfg.resolve_flat_cap(L, F)
    dev = reads.device

    frame_reads, blocks, bp_codes, starts_l, sp, ep = _seed_stage(
        dix, cfg, reads, lengths, frames, min_read_len)

    # ---- flat expansion: slot -> (frame, seed, offset) -------------------
    # Each kept (frame, seed) owns a contiguous run of slots; one scatter
    # marks every run's start with its code and start slot, and a cummax
    # carries them across the packed buffer.
    cnt, sp, starts_l = _order_seeds(cfg, sp, ep, starts_l)      # B,F,S
    cum = torch.cumsum(cnt, dim=-1)
    offs = (cum - cnt).reshape(R, S)
    total = cum[..., -1]                                         # B,F
    frame_occ = torch.clamp(total, max=LB).reshape(R)
    frame_base = torch.cumsum(frame_occ, dim=0) - frame_occ
    overflow = total > LB
    gdrop = ((frame_base + frame_occ > CAP).reshape(B, F)
             & (frame_occ.reshape(B, F) > 0)).any(dim=-1)

    src_ok = (cnt.reshape(R, S) > 0) & (offs < frame_occ[:, None])
    gstart = frame_base[:, None] + offs                          # R,S
    # runs past the buffer are dropped: their slot is clamped into the
    # discarded slot CAP
    dst = torch.where(src_ok, gstart, CAP).reshape(-1).clamp(max=CAP)
    fs_code = (_arange(R, dev)[:, None] * S + _arange(S, dev)).reshape(-1)

    def run_marks(vals):
        buf = torch.zeros(CAP + 1, dtype=_I64, device=dev)
        buf = buf.scatter_reduce(0, dst, vals, reduce="amax")
        return torch.cummax(buf[:CAP], dim=0).values

    fs = run_marks(fs_code)
    gs = run_marks(gstart.reshape(-1))
    g = _arange(CAP, dev)
    n_used = frame_base[-1] + frame_occ[-1]
    ok = g < n_used                           # buffer is packed
    seed_tab = torch.stack(
        [sp.reshape(-1), starts_l.reshape(-1),
         lengths[:, None, None].expand(B, F, S).reshape(-1)], dim=-1)
    picked = seed_tab[fs]
    sa_row = wrap(picked[:, 0] + (g - gs))
    st = picked[:, 1]
    len_b = picked[:, 2]
    fidx = fs // S
    blk = blocks[fidx % F]

    # ---- locate + anchor projection ----------------------------------------
    # no chunked loops on a sharded index, as in the reference
    chunks = 0 if dix.sharded else cfg.flat_chunks
    if chunks > 1:
        (tp,) = _chunked_lanes(
            chunks, n_used, (torch.zeros(CAP, dtype=_I64, device=dev),),
            (blk, sa_row, ok),
            lambda b_, r_, o_: (fm.locate(dix, b_, r_, o_),))
    else:
        tp = fm.locate(dix, blk, sa_row, ok)
    anchor = wrap(tp - st)
    a_ok = ok & (tp >= st) & (
        anchor <= wrap(fm.block_n(dix, blk) - 1 - len_b))
    anchor = torch.where(a_ok, anchor, INVALID)

    # ---- dedup: one sort on (row, anchor) + per-frame unique rank ----------
    # the reference's 2-key lax.sort as one stable sort of row << 32 | anchor;
    # read lengths ride along as a payload (ties carry equal lengths)
    key = (torch.where(a_ok, fidx, R) << 32) | anchor
    keyS, perm = torch.sort(key, stable=True)
    rowS = keyS >> 32
    anchS = keyS & MASK
    lenS = len_b[perm]
    validS = rowS < R
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       keyS[1:] != keyS[:-1]])
    uniq = validS & first
    s_in = torch.cumsum(uniq.to(_I64), dim=0)
    s_excl = s_in - uniq.to(_I64)
    seg_first = torch.full((R + 1,), 1 << 30, dtype=_I64, device=dev)
    seg_first = seg_first.scatter_reduce(0, rowS, s_excl, reduce="amin")
    rank = s_excl - seg_first[torch.clamp(rowS, max=R)]
    nuniq = torch.zeros(R + 1, dtype=_I64, device=dev).scatter_add(
        0, rowS, uniq.to(_I64))
    overflow = overflow | (nuniq[:R].reshape(B, F) > Kc)
    keep = uniq & (rank < Kc)

    # ---- verification on the flat (sorted) lanes ---------------------------
    rowC = torch.clamp(rowS, max=R - 1)
    blkS = blocks[rowC % F]
    cand = torch.where(keep, anchS, 0)
    read_tab = torch.stack(verify.pack_codes(frame_reads), dim=2).reshape(
        R, 3 * Wd)                                # per frame: b0 | b1 | nmask

    def _verify_lanes(blk_, cand_, row_, len_):
        ncols = m + 2 * e
        if cfg.indels and e > 0:
            # one kernel at every bucket width, on a whole or a sharded
            # index: window gather + funnel shifts + Hamming + PEQ + Myers
            return (kernels.verify_fused_gather(
                dix.g_planes, blk_, wrap(cand_ - e), read_tab, row_, len_, L,
                dix.g_words, m, ncols, e),)
        rp = read_tab[row_]                                       # lanes,3*Wd
        rp = (rp[:, :Wd], rp[:, Wd:2 * Wd], rp[:, 2 * Wd:])
        lenmask = verify.length_mask(len_, m)
        ref = verify.window_planes(dix.g_planes, blk_, cand_, Wd, L,
                                   dix.g_words)
        return (verify.hamming(ref, rp, lenmask),)

    v_args = (blkS, cand, rowC, lenS)
    if chunks > 1:
        # valid (sorted-front) lanes only; skipped lanes keep INF and are
        # masked by `keep` below anyway
        (score,) = _chunked_lanes(
            chunks, validS.sum(),
            (torch.full((CAP,), INF, dtype=torch.int32, device=dev),),
            v_args, _verify_lanes)
    else:
        (score,) = _verify_lanes(*v_args)
    score = torch.where(keep & (score <= e), score, INF)

    # ---- scatter back into the dense (B, F, Kc) grids ----------------------
    dst = torch.where(keep, rowS * Kc + rank, R * Kc)
    score_d = _scatter_set(R * Kc + 1, INF, torch.int32, dst, score).reshape(
        B, F, Kc)
    cand_d = _scatter_set(R * Kc + 1, INVALID, _I64, dst, anchS).reshape(
        B, F, Kc)

    fwd = torch.where(blocks[None, :, None] == K.BLOCK_FWD, cand_d,
                      wrap(L - cand_d - lengths[:, None, None]))
    valid = score_d < INF
    return {
        "score": score_d,
        "fwd": torch.where(valid, fwd, INVALID),
        "frame_a": torch.where(valid, cand_d, INVALID),
        "bp": bp_codes[None, :, None].expand(B, F, Kc),
        "overflow": overflow.any(dim=-1), "gdrop": gdrop,
        "frame_reads": frame_reads,
    }


def candidate_stage(dix: DeviceIndex, cfg: AlignerConfig, reads, lengths,
                    frames: tuple[tuple[int, int], ...],
                    min_read_len: int = 0):
    """Dispatch: compacted pipeline (default) or dense reference path."""
    fn = candidate_grids_compact if cfg.compact else candidate_grids
    return fn(dix, cfg, reads, lengths, frames, min_read_len)


def select_se(grids, e: int):
    """Order-free (score, fwd_anchor, block, pat) best/second reduction."""
    B = grids["score"].shape[0]
    sflat = grids["score"].reshape(B, -1)
    aflat = grids["fwd"].reshape(B, -1)
    frame_a = grids["frame_a"].reshape(B, -1)
    bpflat = grids["bp"].reshape(B, -1)

    s_best = sflat.amin(dim=-1)
    m1 = sflat == s_best[:, None]
    a_best = torch.where(m1, aflat, INVALID).amin(dim=-1)
    m2 = m1 & (aflat == a_best[:, None])
    bp_best = torch.where(m2, bpflat, 127).amin(dim=-1)
    m3 = m2 & (bpflat == bp_best[:, None])
    fa_best = torch.where(m3, frame_a, INVALID).amin(dim=-1)

    diff = torch.maximum(frame_a, fa_best[:, None]) - torch.minimum(
        frame_a, fa_best[:, None])
    distinct = (bpflat != bp_best[:, None]) | (diff > e)
    s_second = torch.where(distinct, sflat, INF).amin(dim=-1)
    return {
        "best_score": s_best,
        "best_bp": bp_best,
        "best_anchor": fa_best,
        "second_score": s_second,
        "overflow": grids["overflow"],
        "gdrop": grids["gdrop"],
    }


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
    return select_se(grids, cfg.max_errors)
