"""Paired-end device pipeline (counterpart of bitmapperbs_tpu/models/paired.py).

Runs the SE candidate stages for both mates (mate 2 with the opposite
conversion, oracle.pipeline.se_frames), then: proper-pair join over the
compatible frame pairs, lexicographic pair selection, pair second-best,
per-mate SE selection, and one windowed mate-rescue pass per pair (a Myers
scan over the whole insert window with indels: kernels.rescue_scan, one
launch on the card (two past ~58,000 offsets) on a whole or a sharded
index; per-offset Hamming without).
The host (models/host.map_batch_pe) applies oracle/paired.map_pair's
decision order through models/pool, so SAM equality again
reduces to equality of these tensors.

u32 lanes are int64 (ops/u32.py); every u32 add and subtract that the
reference lets wrap is wrapped here at the same place, because invalid
lanes (no anchor, bp = 127) still reach the output dict.  The pair join
is kernels.pair_join: one launch on the card (csrc/pair.cu: a block per
pair over the valid candidates, no grid); its plain version, which the
wrapper runs on CPU tensors, materializes one (B, Kc, Kc) grid per
compatible frame pair (2 directional, 4 PBAT) and staged reduction.
"""
from __future__ import annotations

import torch

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.device import DeviceIndex
from bitmapperbs_tpu_torch.models.aligner import INF, candidate_stage
from bitmapperbs_tpu_torch.ops import kernels, verify
from bitmapperbs_tpu_torch.ops.u32 import INVALID, wrap
from bitmapperbs_tpu_torch.oracle.pipeline import se_frames

_I64 = torch.int64

_frame_anchor = verify.frame_anchor


def _missing_mate_tables(cfg: AlignerConfig, g1, g2, anch_is_1, opp_pat,
                         ms_len, m: int):
    """Read planes / PEQ / masks of the missing mate at pattern `opp_pat`.

    se_frames gives [own, own(, other, other)] patterns per mate, so frame
    0 carries the mate's own pattern and (PBAT) frame 2 the opposite.  In
    directional mode the opposite pattern of the anchored mate is always
    the missing mate's own pattern (frame 0)."""
    def tables(grids, want_alt):
        fr = grids["frame_reads"]
        return fr[:, 2 if (want_alt and fr.shape[1] > 2) else 0]

    a1 = anch_is_1[:, None]
    if not cfg.non_directional:
        ms_reads = torch.where(a1, tables(g2, False), tables(g1, False))
    else:
        ms_reads = torch.where(
            a1,
            torch.where((opp_pat == K.PAT_GA)[:, None], tables(g2, False),
                        tables(g2, True)),
            torch.where((opp_pat == K.PAT_CT)[:, None], tables(g1, False),
                        tables(g1, True)))
    planes = verify.pack_codes(ms_reads)
    lenmask = verify.length_mask(ms_len, m)
    peq, pad = verify.build_peq(ms_reads, ms_len, m)
    return planes, peq, pad, lenmask


def _rescue_scan(dix: DeviceIndex, cfg: AlignerConfig, block, lo, hi, r_ok,
                 ms_len, ms_peq, ms_pad, m: int):
    """One semi-global Myers scan per pair over the whole insert window
    (oracle/paired.rescue's frozen spec): the per-offset banded DPs'
    alignment sets union to the scan's infix set.  Column j is the REAL
    read's alignment ending at win_start + j - (m - length), since pad rows
    shift by m - length (verify.myers_scan)."""
    e = cfg.max_errors
    L = dix.genome_len
    R = cfg.max_insert - cfg.min_insert + 1
    a_lo = torch.where(block == 0, lo, wrap(L - hi - ms_len))
    span = wrap(hi - lo)                                  # == a_hi - a_lo
    win_start = torch.where(r_ok, wrap(a_lo - e), 0)      # wrap >= -e legal
    # one launch on the card, on a whole or a sharded index: the window
    # fetch, the scan over R + m + 2e columns and the (best, lowest
    # position, second) selection
    return kernels.rescue_scan(dix.g_planes, block, win_start, r_ok, a_lo,
                               span, ms_len, ms_peq, ms_pad, L, dix.g_words,
                               m, e, R)


def _rescue_hamming(dix: DeviceIndex, cfg: AlignerConfig, block, lo, hi,
                    r_ok, ms_len, ms_planes, ms_lenmask, m: int):
    """Mismatch-only rescue: per-offset Hamming over the window (frozen
    spec), (B, R) lanes."""
    e = cfg.max_errors
    L = dix.genome_len
    R = cfg.max_insert - cfg.min_insert + 1
    B = block.shape[0]
    p = wrap(lo[:, None] + torch.arange(R, dtype=_I64, device=lo.device))
    p_ok = r_ok[:, None] & (p >= lo[:, None]) & (p <= hi[:, None])
    a_ms = _frame_anchor(p, block[:, None], ms_len[:, None], L)
    ref = verify.window_planes(dix.g_planes, block[:, None].expand(B, R),
                               torch.where(p_ok, a_ms, 0), m // 32, L,
                               dix.g_words)
    rham = verify.hamming(ref, tuple(pl[:, None, :] for pl in ms_planes),
                          ms_lenmask[:, None, :])
    rscore = torch.where(p_ok & (rham <= e), rham, INF)   # B,R
    rs_best = rscore.amin(dim=-1)
    rm1 = rscore == rs_best[:, None]
    rp_best = torch.where(rm1, p, INVALID).amin(dim=-1)
    rdiff = torch.maximum(p, rp_best[:, None]) - torch.minimum(
        p, rp_best[:, None])
    rs_second = torch.where(rdiff > e, rscore, INF).amin(dim=-1)
    return rs_best, rp_best, rs_second


def map_batch_pe_device(dix: DeviceIndex, cfg: AlignerConfig, reads1,
                        lengths1, reads2, lengths2, min_read_len1: int = 0,
                        min_read_len2: int = 0):
    """Paired batch -> decision inputs for the host PE assembler.

    reads1/reads2: uint8[B, m_pad] (pad = N), lengths1/lengths2 int[B], on
    dix's device; min_read_len1/2: host-known shortest length of each mate
    in the batch (0 = unknown), as in map_batch_device.  Returns the
    reference's dict: pair_* (best proper pair, its second-best sum),
    se1/se2 (kernels.select_se per mate), resc_* (mate rescue from the
    better mate's SE hit), and gdrop (either mate; host must re-run
    dense)."""
    B, m = reads1.shape
    e = cfg.max_errors
    L = dix.genome_len
    frames1 = tuple(se_frames(cfg, mate=0))
    frames2 = tuple(se_frames(cfg, mate=1))
    m1 = lengths1.to(_I64)
    m2 = lengths2.to(_I64)

    g1 = candidate_stage(dix, cfg, reads1, m1, frames1, min_read_len1)
    g2 = candidate_stage(dix, cfg, reads2, m2, frames2, min_read_len2)

    # best proper pair by (sum, fwd1, fwd2, bp1, bp2), its mate-1 score and
    # frame anchors, and the best sum at a distinct locus: one launch
    (psum, _, _, pbp1, pbp2), best_s1, pa1, pa2, second_sum = \
        kernels.pair_join(g1["score"], g1["fwd"], g2["score"], g2["fwd"],
                          frames1, frames2, m1, m2, L, e, cfg.min_insert,
                          cfg.max_insert)

    se1 = kernels.select_se(g1, e)
    se2 = kernels.select_se(g2, e)

    # ---- mate rescue: anchored mate = smaller SE key (score, fwd, bp) -----
    f1fwd = _frame_anchor(se1["best_anchor"], se1["best_bp"] >> 1, m1, L)
    f2fwd = _frame_anchor(se2["best_anchor"], se2["best_bp"] >> 1, m2, L)
    s1, s2 = se1["best_score"], se2["best_score"]
    anch_is_1 = (s1 < INF) & ((s2 >= INF) | ~kernels.lex_lt(
        (s2, f2fwd, se2["best_bp"]), (s1, f1fwd, se1["best_bp"])))
    have_anchor = (s1 < INF) | (s2 < INF)
    A = torch.where(anch_is_1, f1fwd, f2fwd)             # fwd anchor
    a_bp = torch.where(anch_is_1, se1["best_bp"], se2["best_bp"])
    # bp = 127 (no anchor) reads entry 3, as the reference's clamped gather
    bp_c = a_bp.clamp(0, 3)
    a_rev = torch.zeros_like(bp_c, dtype=torch.bool)
    for bp, rev in enumerate(kernels.REV_BY_BP):
        if rev:
            a_rev |= bp_c == bp
    a_len = torch.where(anch_is_1, m1, m2)
    ms_len = torch.where(anch_is_1, m2, m1)              # missing mate
    block = (a_bp >> 1).clamp(0, 1)
    opp_pat = 1 - (a_bp & 1)
    ms_planes, ms_peq, ms_pad, ms_lenmask = _missing_mate_tables(
        cfg, g1, g2, anch_is_1, opp_pat, ms_len, m)

    # fwd offset range [lo, hi] with the reference's u32 underflow guards:
    # a negative hi means "no rescue window", never a wrapped huge window
    A_len = wrap(A + a_len)
    A_min = wrap(A + cfg.min_insert)
    A_max = wrap(A + cfg.max_insert)
    lo = torch.where(
        a_rev,
        torch.where(A_len >= cfg.max_insert, A_len - cfg.max_insert, 0),
        torch.where(A_min >= ms_len, A_min - ms_len, 0))
    hi_ok = torch.where(a_rev, A_len >= cfg.min_insert, A_max >= ms_len)
    hi = torch.where(
        a_rev,
        torch.where(A_len >= cfg.min_insert, A_len - cfg.min_insert, 0),
        torch.where(A_max >= ms_len, A_max - ms_len, 0))
    hi = torch.minimum(hi, wrap(L - ms_len))
    r_ok = have_anchor & hi_ok & (lo <= hi)

    if cfg.indels and e > 0:
        rs_best, rp_best, rs_second = _rescue_scan(
            dix, cfg, block, lo, hi, r_ok, ms_len, ms_peq, ms_pad, m)
    else:
        rs_best, rp_best, rs_second = _rescue_hamming(
            dix, cfg, block, lo, hi, r_ok, ms_len, ms_planes, ms_lenmask, m)

    return {
        "pair_valid": psum < 2 * INF,
        "gdrop": g1["gdrop"] | g2["gdrop"],
        "pair_sum": psum, "pair_second_sum": second_sum,
        "pair_s1": best_s1,
        "pair_a1": pa1, "pair_bp1": pbp1,
        "pair_a2": pa2, "pair_bp2": pbp2,
        "se1": se1, "se2": se2,
        "resc_valid": have_anchor & (rs_best < INF),
        "resc_anch_is_1": anch_is_1,
        "resc_fwd": rp_best, "resc_score": rs_best,
        "resc_second": rs_second,
        "resc_block": block, "resc_pat": opp_pat,
    }
