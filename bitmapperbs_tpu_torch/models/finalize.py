"""Batched host finalization: vectorized traceback-free SAM field
construction for ungapped alignments (SURVEY.md C13/C18 at device speed).

oracle/pipeline.finalize_hit is the per-read spec; at ~100k mapped reads/s
its per-read Python DP + per-character MD/XM loops are ~1000x too slow
(measured 116 reads/s end-to-end).  The frozen spec emits the UNGAPPED
alignment whenever it achieves the reported score -- true for every read
scored by the Hamming fast path, i.e. all but the rare indel reads -- so
this module computes those records with batched numpy (window gathers,
vectorized asymmetric compare, vectorized Bismark-context XM strings) and
falls back to finalize_hit only for gapped reads.  Output records are
byte-identical to finalize_hit's (tests/test_finalize_batch.py).
"""
from __future__ import annotations

import numpy as np

from bitmapperbs_tpu_torch import constants as K
from bitmapperbs_tpu_torch.config import AlignerConfig
from bitmapperbs_tpu_torch.index.build import BSIndex
from bitmapperbs_tpu_torch.io.sam import SamRecord
from bitmapperbs_tpu_torch.oracle.pipeline import Hit, finalize_hit
from bitmapperbs_tpu_torch.utils import dna

_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)
# (block, pat) -> (XR, XG) / reverse-flag, indexed as block*2 + pat
_TAG4 = [None] * 4
for _b in (0, 1):
    for _p in (0, 1):
        _TAG4[_b * 2 + _p] = K.CONV_TAGS[(_b, _p)]
_REV4 = np.array([K.IS_REVERSE[(b, p)] for b in (0, 1) for p in (0, 1)],
                 dtype=bool)
# gap 0..3 -> mapq, [4] = no-second / cap (the K.mapq_from_gap rule as an
# array; shared with models/native_finalize.py)
_MQ_TAB = np.array([K.MAPQ_TABLE[g] for g in range(4)] + [K.MAPQ_MAX],
                   dtype=np.int32)


def _gather_windows(codes: np.ndarray, starts: np.ndarray, width: int,
                    L: int) -> np.ndarray:
    """codes[starts[i] + j] for j < width, N-filled out of [0, L)."""
    idx = starts[:, None] + np.arange(width, dtype=np.int64)
    oob = (idx < 0) | (idx >= L)
    out = codes[np.clip(idx, 0, L - 1)]
    out[oob] = K.N_CODE
    return out


def _oriented_rows(arr: np.ndarray, lens: np.ndarray, rev: np.ndarray,
                   m_max: int) -> np.ndarray:
    """uint8 [n, m_max]: row r = arr[r, :lens[r]], reverse-complemented where
    rev[r], N-padded -- the vectorized replacement for a per-read
    fill-and-revcomp loop."""
    w = arr.shape[1]
    j = np.arange(m_max)
    src = np.where(rev[:, None], lens[:, None] - 1 - j[None, :], j[None, :])
    vals = arr[np.arange(len(arr))[:, None], np.clip(src, 0, w - 1)]
    vals = np.where(rev[:, None], dna._COMP[vals], vals)
    return np.where(j[None, :] < lens[:, None], vals,
                    K.N_CODE).astype(np.uint8)


def finalize_batch(idx: BSIndex, rc_ref: np.ndarray, cfg: AlignerConfig,
                   reads, quals, qnames, hits,
                   flag_extras=None, mapq_overrides=None, padded=None):
    """Vectorized equivalent of [finalize_hit(...) for each read].

    hits: list of (best Hit | None, second Hit | None).  Returns a list of
    SamRecord | None (None = unmapped / rejected / suppressed-ambiguous),
    byte-identical to per-read finalize_hit.
    padded: optional (uint8[n, bucket] N-padded array, int lengths[n])
    covering `reads` -- callers that already hold the device batch pass it
    so no per-read row fills happen here.
    """
    n = len(reads)
    if padded is None:
        lens_all = np.array([len(r) for r in reads], dtype=np.int64)
        arr_all = np.full((n, int(lens_all.max()) if n else 1), K.N_CODE,
                          dtype=np.uint8)
        for i, r in enumerate(reads):
            arr_all[i, :len(r)] = r
    else:
        arr_all = np.asarray(padded[0], dtype=np.uint8)
        lens_all = np.asarray(padded[1], dtype=np.int64)[:n]
    rows = [i for i, (b, _) in enumerate(hits) if b is not None]
    if not rows:
        return [None] * n
    a_arr = np.array([hits[i][0].anchor for i in rows], dtype=np.int64)
    blk = np.array([hits[i][0].block for i in rows], dtype=np.int64)
    pat = np.array([hits[i][0].pat for i in rows], dtype=np.int64)
    score = np.array([hits[i][0].score for i in rows], dtype=np.int64)
    sec_sc = np.array([(hits[i][1].score if hits[i][1] is not None else -1)
                       for i in rows], dtype=np.int64)
    return _finalize_core(idx, rc_ref, cfg, arr_all, lens_all, quals, qnames,
                          n, rows, a_arr, blk, pat, score, sec_sc,
                          lambda i: hits[i], flag_extras, mapq_overrides)


def finalize_batch_device(idx: BSIndex, rc_ref: np.ndarray,
                          cfg: AlignerConfig, arr, lengths, quals, qnames,
                          out_np, flag_extras=None, mapq_overrides=None):
    """finalize_batch fed straight from the device output dict -- no
    per-read Hit objects (they cost ~10us/read at 100k+ reads/s; profiled
    as a top-3 host cost).  Semantics identical to
    device_results_to_hits + finalize_batch (models/pool.py keeps that
    pair as the spec; tests assert record equality)."""
    n = len(qnames)
    bs = np.asarray(out_np["best_score"], dtype=np.int64)[:n]
    bp = np.asarray(out_np["best_bp"], dtype=np.int64)[:n]
    ba = np.asarray(out_np["best_anchor"], dtype=np.int64)[:n]
    ss = np.asarray(out_np["second_score"], dtype=np.int64)[:n]
    arr_all = np.asarray(arr, dtype=np.uint8)
    lens_all = np.asarray(lengths, dtype=np.int64)[:n]
    rows_a = np.flatnonzero(bs < K.INF_SCORE)
    if len(rows_a) == 0:
        return [None] * n
    rows = rows_a.tolist()
    blk = bp[rows_a] >> 1
    pat = bp[rows_a] & 1
    a_arr = ba[rows_a]
    score = bs[rows_a]
    sec_sc = np.where(ss[rows_a] < K.INF_SCORE, ss[rows_a], -1)

    def degen_pair(i):
        from bitmapperbs_tpu_torch.oracle.pipeline import Hit
        b, p = int(bp[i]) >> 1, int(bp[i]) & 1
        a = int(ba[i])
        fwd = (a if b == K.BLOCK_FWD
               else idx.genome.length - a - int(lens_all[i]))
        second = Hit(int(ss[i]), 0, 0, 0, 0) if ss[i] < K.INF_SCORE else None
        return Hit(int(bs[i]), fwd, b, p, a), second

    return _finalize_core(idx, rc_ref, cfg, arr_all, lens_all, quals, qnames,
                          n, rows, a_arr, blk, pat, score, sec_sc,
                          degen_pair, flag_extras, mapq_overrides)


def _finalize_core(idx, rc_ref, cfg, arr_all, lens_all, quals, qnames,
                   n, rows, a_arr, blk, pat, score, sec_sc, degen_pair,
                   flag_extras, mapq_overrides):
    out: list[SamRecord | None] = [None] * n
    e = cfg.max_errors
    L = idx.genome.length
    gcodes = idx.genome.codes
    m_arr = lens_all[rows]
    has2 = sec_sc >= 0
    amb_all = has2 & (sec_sc == score)
    mapq_all = np.where(has2, _MQ_TAB[np.clip(sec_sc - score, 0, 4)],
                        K.MAPQ_MAX)
    mapq_all = np.where(amb_all, 0, mapq_all)

    m_max = int(m_arr.max())
    arr_rows = arr_all[rows]
    fr = _oriented_rows(arr_rows, m_arr, pat != K.PAT_CT, m_max)
    inlen = np.arange(m_max)[None, :] < m_arr[:, None]

    # frame window at the anchor: block 0 reads W, block 1 reads rc(W)
    fwin = np.empty((len(rows), m_max), dtype=np.uint8)
    for b, ref in ((K.BLOCK_FWD, gcodes), (K.BLOCK_RC, rc_ref)):
        sel = blk == b
        if sel.any():
            fwin[sel] = _gather_windows(ref, a_arr[sel], m_max, L)
    # frame-space asymmetric rule is always CT; pad rows auto-match
    match = ((fwin == fr) | ((fwin == K.C) & (fr == K.T))) \
        & (fwin != K.N_CODE) & (fr != K.N_CODE)
    ham = (~match & inlen).sum(axis=1)
    fast = (ham == score) if cfg.indels else np.ones(len(rows), dtype=bool)

    # ---- slow path: gapped reads -------------------------------------------
    # The spec's per-read python DP is O(m*w) interpreted ops; here all slow
    # reads' DP matrices are computed in one batched pass (the horizontal
    # chain D[i,j] = min(b_j, D[i,j-1]+1) unrolls to a prefix-min of b_k - k,
    # so each row is a vectorized minimum.accumulate), and the backtrace walk
    # runs in lockstep across all slow reads (each step is a handful of
    # fancy-index gathers).  finalize_hit gets the precomputed
    # (ref_start, cigar) via traceback_pre and does no per-read DP at all.
    slow = np.flatnonzero(~fast)
    if len(slow) > 0:
        ns = len(slow)
        w_max = m_max + 2 * e
        swin = np.empty((ns, w_max), dtype=np.uint8)
        for b, ref in ((K.BLOCK_FWD, gcodes), (K.BLOCK_RC, rc_ref)):
            sel = blk[slow] == b
            if sel.any():
                swin[sel] = _gather_windows(
                    ref, a_arr[slow][sel] - e, w_max, L)
        sfr = fr[slow]
        # asym match table [ns, m_max, w_max] (read index i-1, window j-1)
        mtab = (((swin[:, None, :] == sfr[:, :, None])
                 | ((swin[:, None, :] == K.C) & (sfr[:, :, None] == K.T)))
                & (swin[:, None, :] != K.N_CODE)
                & (sfr[:, :, None] != K.N_CODE))
        # Banded DP in diagonal coordinates d = j - i, d in [-e, 6e].
        # Why this band is faithful to the full matrix (the frozen spec):
        # with score <= e, any end column lies in [m-e, m+2e] (d <= 2e) and
        # its witness alignment starts at s = j_end - span <= 3e, so every
        # walked cell has d in [s-e, s+e] subset [-e, 4e] (and d >= -e
        # because s >= 0).  The backtrace also COMPARES the diag/left
        # neighbors of walked cells (d' <= 4e); a compared cell with true
        # value v' <= e is exact in-band because its own optimal path stays
        # within d <= d' + 2v' <= 6e (s' >= 0 bounds the low side at -e).
        # Cells below -e have true value > e (>= forced insertions), so
        # treating them as INF preserves every comparison.  Values are
        # int16 and exact in-band; the j = 0 boundary column emerges from
        # the row-0 base (j < 0 cells are INF), so no separate i + j cap
        # term is needed.  ~3.5x fewer cells than the full-width rows.
        B = 7 * e + 1                       # d = didx - e
        INF16 = np.int16(2 ** 13)
        # padded mismatch rows: row i reads j-1 = (i-1)-e .. (i-1)+6e, i.e.
        # subP[:, i-1, (i-1):(i-1)+B] with a left pad of e and right pad 4e
        subP = np.ones((ns, m_max, e + w_max + 4 * e), dtype=np.int16)
        subP[:, :, e:e + w_max] = ~mtab
        D = np.full((ns, m_max + 1, B), INF16, dtype=np.int16)
        D[:, 0, e:] = 0                     # row 0: j = d >= 0 is free start
        idxB = np.arange(B, dtype=np.int16)
        for i in range(1, m_max + 1):
            prev = D[:, i - 1, :]
            up = np.concatenate(            # (i-1, j) sits one diagonal up
                [prev[:, 1:], np.full((ns, 1), INF16, np.int16)], axis=1)
            b_row = np.minimum(prev + subP[:, i - 1, i - 1:i - 1 + B],
                               up + 1)
            run = np.minimum.accumulate(b_row - idxB, axis=1)
            D[:, i, :] = run + idxB
        # Per-cell backtrace direction, ONE vectorized 3D pass (1 = M diag,
        # 2 = D left, 3 = I up; priority M > D > I with the same j>0 /
        # didx>0 guards the former per-step comparisons used).  The walk
        # below then needs one gather per step instead of ~15 numpy ops
        # re-deriving the comparisons (profiled as the dominant finalize
        # cost on gapped batches).  subP's per-row moving slice
        # [i-1 : i-1+B] is a strided diagonal view (no copy).
        from numpy.lib.stride_tricks import as_strided
        s0, s1, s2 = subP.strides
        W = as_strided(subP, shape=(ns, m_max, B),
                       strides=(s0, s1 + s2, s2))
        Dk = D[:, 1:, :]
        m_all = Dk == (D[:, :-1, :] + W)
        left_all = np.empty_like(Dk)
        left_all[:, :, 0] = INF16           # didx 0 has no left neighbor;
        left_all[:, :, 1:] = Dk[:, :, :-1]  # INF16+1 never equals a value
        d_all = (Dk == left_all + 1) & ~m_all
        for i in range(1, min(e, m_max) + 1):
            m_all[:, i - 1, :e - i + 1] = False   # j = i+didx-e > 0 guard
            d_all[:, i - 1, :e - i + 1] = False
        dirs = np.zeros((ns, m_max + 1, B), dtype=np.uint8)
        dirs[:, 1:, :] = (3 - 2 * m_all.astype(np.uint8)
                          - d_all.astype(np.uint8))
        m_slow = m_arr[slow]
        w_slow = m_slow + 2 * e
        # end column: smallest j over the VALID window achieving the row
        # min; in band coords j = m_slow + didx - e, so the j <= w_slow
        # mask is didx <= 3e and smallest didx = smallest j
        rr = np.arange(ns)
        band_last = D[rr, m_slow, :]
        jb = m_slow[:, None] + np.arange(B)[None, :] - e
        band_last = np.where((jb >= 0) & (jb <= w_slow[:, None]),
                             band_last, np.int16(2 ** 14))
        didx0 = np.argmin(band_last, axis=1)
        jcur = (m_slow + didx0 - e).astype(np.int64)
        icur = m_slow.copy()
        # lockstep backtrace; ops stored walk-order (alignment end -> start)
        # 0 = done, 1 = M, 2 = D (ref gap), 3 = I (read gap)
        max_steps = int((m_slow + w_slow).max()) if ns else 0
        opbuf = np.zeros((ns, max_steps), dtype=np.uint8)
        step = 0
        active = icur > 0
        while active.any():
            didx = np.clip(jcur - icur + e, 0, B - 1)
            op = np.where(active, dirs[rr, icur, didx], 0)
            opbuf[:, step] = op
            icur -= active & (op != 2)      # M/I consume a read base
            jcur -= active & (op != 3)      # M/D consume a window base
            active = icur > 0
            step += 1
        nsteps = (opbuf != 0).sum(axis=1)
        # Light per-read pass: trim leading/trailing D runs (frame space),
        # record the frame position, and lay the trimmed ops out
        # chronologically in FWD orientation (a hit on the reverse strand's
        # frame, block 1, has the frame cigar reversed; the read's own
        # orientation, FLAG 0x10, differs from it on the G->A frames and
        # does not enter).  Everything downstream -- match table,
        # NM, Bismark XM, MD events -- is then computed in one vectorized
        # pass over the (ns, A_max) aligned-column grid, mirroring
        # oracle/align.cigar_md_nm column for column; only MD/CIGAR string
        # formatting stays per-read (a handful of events each).
        blkS = blk[slow]
        patS = pat[slow]
        revS = _REV4[blkS * 2 + patS]
        # vectorized trim: lay the walk-order opbuf out chronologically via
        # index math, find the first/last non-D columns with argmax, and
        # build the fwd-orientation ops grid with one fancy-index gather --
        # no per-read python trim loop
        A0 = max(int(nsteps.max()) if ns else 1, 1)
        jj = np.arange(A0)
        src = nsteps[:, None] - 1 - jj[None, :]
        chron = np.where(
            src >= 0,
            opbuf[rr[:, None], np.clip(src, 0, max(opbuf.shape[1] - 1, 0))],
            0).astype(np.uint8)
        keepm = (chron != 2) & (chron != 0)         # trim leading/trailing D
        any_keep = keepm.any(axis=1)
        first = np.argmax(keepm, axis=1)
        last = A0 - 1 - np.argmax(keepm[:, ::-1], axis=1)
        tlenS = np.where(any_keep, last - first + 1, 0).astype(np.int64)
        degen = ~any_keep                           # empty alignment: spec
        degen_ref_start = jcur + nsteps
        frame_pos = a_arr[slow] - e + jcur + first
        A_max = max(int(tlenS.max()), 1)
        j2 = np.arange(A_max)
        within = j2[None, :] < tlenS[:, None]
        src2 = first[:, None] + np.where((blkS == K.BLOCK_RC)[:, None],
                                         tlenS[:, None] - 1 - j2[None, :],
                                         j2[None, :])
        ops_f = np.where(within,
                         chron[rr[:, None], np.clip(src2, 0, A0 - 1)],
                         0).astype(np.uint8)
        isM = ops_f == 1
        isD = ops_f == 2
        isI = ops_f == 3
        rc_col = isM | isI                          # read-consuming columns
        fc_col = isM | isD                          # ref-consuming columns
        readpos = np.cumsum(rc_col, axis=1) - rc_col
        refoff = np.cumsum(fc_col, axis=1) - fc_col
        ref_spanS = fc_col.sum(axis=1).astype(np.int64)
        fwd_posS = np.where(blkS == K.BLOCK_FWD, frame_pos,
                            L - frame_pos - ref_spanS)
        ciS = np.searchsorted(idx.genome.offsets, fwd_posS,
                              side="right") - 1
        coordS = fwd_posS - idx.genome.offsets[ciS]
        in_contigS = (coordS >= 0) & (coordS + ref_spanS
                                      <= idx.genome.lengths[ciS])
        gaS = blkS == K.BLOCK_RC

        fwd_readS = _oriented_rows(arr_rows[slow], m_arr[slow], revS, m_max)

        q = fwd_posS[:, None] + refoff              # abs fwd genome pos
        qin = (q >= 0) & (q < L) & fc_col
        rq = np.where(qin, gcodes[np.clip(q, 0, L - 1)], K.N_CODE)
        rd = fwd_readS[np.arange(ns)[:, None],
                       np.minimum(readpos, max(m_max - 1, 0))]
        rd = np.where(rc_col, rd, K.N_CODE)
        ref_cS = np.where(gaS, K.G, K.C).astype(np.uint8)[:, None]
        bsm = np.where(gaS[:, None], (rq == K.G) & (rd == K.A),
                       (rq == K.C) & (rd == K.T))
        eqm = ((rq == rd) | bsm) & (rq != K.N_CODE) & (rd != K.N_CODE)
        matchedM = isM & eqm
        mmM = isM & ~eqm
        nmS = (mmM | isD | isI).sum(axis=1)

        # Bismark context letters at ref-C match columns (vectorized
        # align.meth_context; GA strand looks upstream, complemented)
        dq = np.where(gaS, -1, 1).astype(np.int64)[:, None]
        q1, q2 = q + dq, q + 2 * dq
        b1 = np.where((q1 >= 0) & (q1 < L),
                      gcodes[np.clip(q1, 0, L - 1)], K.N_CODE)
        b2 = np.where((q2 >= 0) & (q2 < L),
                      gcodes[np.clip(q2, 0, L - 1)], K.N_CODE)
        gsymS = np.where(gaS, K.C, K.G).astype(np.uint8)[:, None]
        ctxS = np.where(
            b1 == gsymS, ord("z"),
            np.where(b1 == K.N_CODE, ord("u"),
                     np.where(b2 == gsymS, ord("x"),
                              np.where(b2 == K.N_CODE, ord("u"),
                                       ord("h"))))).astype(np.uint8)
        is_cS = matchedM & (rq == ref_cS)
        methS = rd == ref_cS                        # unconverted cytosine
        xm_mat = np.full((ns, max(m_max, 1)), ord("."), dtype=np.uint8)
        rsel, csel = np.nonzero(is_cS)
        xm_mat[rsel, readpos[rsel, csel]] = np.where(
            methS[rsel, csel], ctxS[rsel, csel] - 32, ctxS[rsel, csel])
        seqS = _BASE[fwd_readS]
        rq_chr = _BASE[rq]
        cummatch = np.cumsum(matchedM, axis=1) - matchedM
        totmatch = matchedM.sum(axis=1)
        evmask = mmM | isD

        # bulk scalar conversion (same technique as the fast path below):
        # MD events from ONE global nonzero, scalars via tolist, whole-array
        # latin-1 decodes sliced per record
        mS_l = m_arr[slow].tolist()
        coordS_l = coordS.tolist()
        ciS_l = ciS.tolist()
        in_contigS_l = in_contigS.tolist()
        revS_l = revS.tolist()
        degen_l = degen.tolist()
        ambS_l = amb_all[slow].tolist()
        mapqS_l = mapq_all[slow].tolist()
        nmS_l = nmS.tolist()
        totS_l = totmatch.tolist()
        namesS = idx.genome.names
        m_maxS = max(m_max, 1)
        opsS_l = ops_f.tolist()
        tlenS_l = tlenS.tolist()
        seqS_str = seqS.tobytes().decode("latin-1")
        xmS_str = xm_mat.tobytes().decode("latin-1")
        tagsS_l = [_TAG4[v] for v in (blkS * 2 + patS).tolist()]
        ev_r, ev_c = np.nonzero(evmask)         # row-major: grouped by read
        ev_c_l = ev_c.tolist()
        ev_cm_l = cummatch[ev_r, ev_c].tolist()
        ev_isD_l = isD[ev_r, ev_c].tolist()
        ev_ch = rq_chr[ev_r, ev_c].tobytes().decode("latin-1")
        ev_cnt_l = evmask.sum(axis=1).tolist()
        md_s: list[str] = [""] * ns
        pe = 0
        for t in range(ns):
            cnt = ev_cnt_l[t]
            if cnt == 0:
                md_s[t] = str(totS_l[t])
                continue
            parts = []
            prevm = 0
            u, end = pe, pe + cnt
            while u < end:
                cm = ev_cm_l[u]
                parts.append(str(cm - prevm))
                prevm = cm
                if ev_isD_l[u]:
                    v = u                       # group the full D run
                    while (v + 1 < end and ev_c_l[v + 1] == ev_c_l[v] + 1
                           and ev_isD_l[v + 1]):
                        v += 1
                    parts.append("^" + ev_ch[u:v + 1])
                    u = v + 1
                else:
                    parts.append(ev_ch[u])
                    u += 1
            parts.append(str(totS_l[t] - prevm))
            md_s[t] = "".join(parts)
            pe = end

        rep_ambS = cfg.report_ambiguous
        FLAG_REVS = K.FLAG_REVERSE
        for t, k in enumerate(slow):
            i = rows[k]
            if degen_l[t]:
                d_best, d_second = degen_pair(i)
                out[i] = finalize_hit(
                    idx, rc_ref, cfg, arr_all[i, :lens_all[i]],
                    quals[i], qnames[i], d_best, d_second,
                    flag_extra=flag_extras[i] if flag_extras else 0,
                    mapq_override=(mapq_overrides[i] if mapq_overrides
                                   else None),
                    traceback_pre=(int(degen_ref_start[t]), []))
                continue
            if not in_contigS_l[t]:
                continue                            # leaves contig: reject
            if ambS_l[t] and not rep_ambS:
                continue
            mapq = mapqS_l[t]
            if mapq_overrides and mapq_overrides[i] is not None:
                mapq = mapq_overrides[i]
            o_l = opsS_l[t][:tlenS_l[t]]            # short: RLE in python
            cig_parts = []
            run_op, run_n = o_l[0], 1
            for op in o_l[1:]:
                if op == run_op:
                    run_n += 1
                else:
                    cig_parts.append("%d%s" % (run_n, "\0MDI"[run_op]))
                    run_op, run_n = op, 1
            cig_parts.append("%d%s" % (run_n, "\0MDI"[run_op]))
            m = mS_l[t]
            qual = quals[i]
            rv = revS_l[t]
            xr, xg = tagsS_l[t]
            base = t * m_maxS
            out[i] = SamRecord(
                qnames[i],
                (FLAG_REVS if rv else 0)
                | (flag_extras[i] if flag_extras else 0),
                namesS[ciS_l[t]],
                coordS_l[t] + 1,
                mapq,
                "".join(cig_parts),
                "*", 0, 0,
                seqS_str[t * m_max:t * m_max + m],
                (qual[::-1] if rv else qual) if qual else "*",
                nmS_l[t],
                md_s[t],
                xmS_str[base:base + m],
                xr, xg,
            )

    f = np.flatnonzero(fast)
    if len(f) == 0:
        return out

    # bulk per-record scalars for the fast path: the per-record python loop
    # is the finalize bottleneck (profiled: ~70% of finalize time was int()
    # casts, per-read flatnonzero, and np-scalar formatting), so every
    # per-record quantity is converted to python scalars in one C pass

    # ---- fast path: ungapped records, fully vectorized ---------------------
    mF = m_arr[f]
    blkF = blk[f]
    patF = pat[f]
    fwd_pos = np.where(blkF == K.BLOCK_FWD, a_arr[f], L - a_arr[f] - mF)
    ci = np.searchsorted(idx.genome.offsets, fwd_pos, side="right") - 1
    coord = fwd_pos - idx.genome.offsets[ci]
    in_contig = (coord >= 0) & (coord + mF <= idx.genome.lengths[ci])

    rev = _REV4[blkF * 2 + patF]
    ga = blkF == K.BLOCK_RC

    # fwd-orientation read and genome context window [pos-2, pos+m+2)
    fwd_read = _oriented_rows(arr_rows[f], mF, rev, m_max)
    ctxw = _gather_windows(gcodes, fwd_pos - 2, m_max + 4, L)
    gwin = ctxw[:, 2:m_max + 2]             # fwd genome window, width m_max
    inlenF = np.arange(m_max)[None, :] < mF[:, None]

    ref_c = np.where(ga, K.G, K.C).astype(np.uint8)[:, None]
    bs = np.where(ga[:, None], (gwin == K.G) & (fwd_read == K.A),
                  (gwin == K.C) & (fwd_read == K.T))
    matchF = ((gwin == fwd_read) | bs) \
        & (gwin != K.N_CODE) & (fwd_read != K.N_CODE) & inlenF
    mism = ~matchF & inlenF

    # Bismark context letters at every ref-C position (vectorized
    # align.meth_context): CT strand looks at +1/+2, GA strand at -1/-2
    # complemented (G plays C's role)
    b1 = np.where(ga[:, None], ctxw[:, 1:m_max + 1], ctxw[:, 3:m_max + 3])
    b2 = np.where(ga[:, None], ctxw[:, 0:m_max], ctxw[:, 4:m_max + 4])
    gsym = np.where(ga, K.C, K.G).astype(np.uint8)[:, None]
    ctx = np.where(
        b1 == gsym, ord("z"),
        np.where(b1 == K.N_CODE, ord("u"),
                 np.where(b2 == gsym, ord("x"),
                          np.where(b2 == K.N_CODE, ord("u"),
                                   ord("h"))))).astype(np.uint8)
    is_c = matchF & (gwin == ref_c)
    meth = fwd_read == ref_c                 # unconverted cytosine
    ctx_cased = np.where(meth, ctx - 32, ctx)          # upper when methylated
    xm_arr = np.where(is_c, ctx_cased, ord(".")).astype(np.uint8)
    xm_arr[~inlenF] = 0

    seq_arr = _BASE[fwd_read]

    # one C-speed pass per quantity (python scalars via tolist; whole-array
    # latin-1 decodes sliced per record; MD built from ONE global nonzero)
    m_l = mF.tolist()
    coord_l = coord.tolist()
    ci_l = ci.tolist()
    in_contig_l = in_contig.tolist()
    rev_l = rev.tolist()
    amb_l = amb_all[f].tolist()
    mapq_l = mapq_all[f].tolist()
    nm_l = mism.sum(axis=1).tolist()
    names = idx.genome.names
    seq_str = seq_arr.tobytes().decode("latin-1")
    xm_str = xm_arr.tobytes().decode("latin-1")
    tags_l = [_TAG4[v] for v in (blkF * 2 + patF).tolist()]
    ev_t, ev_q = np.nonzero(mism)              # row-major: grouped by read
    ev_q_l = ev_q.tolist()
    ev_ch = _BASE[gwin[ev_t, ev_q]].tobytes().decode("latin-1")
    md_l: list[str] = [""] * len(f)
    pos_ev = 0
    for t in range(len(f)):
        cnt = nm_l[t]
        if cnt == 0:
            md_l[t] = str(m_l[t])
            continue
        parts = []
        prev = 0
        for u in range(pos_ev, pos_ev + cnt):
            q = ev_q_l[u]
            parts.append(str(q - prev))
            parts.append(ev_ch[u])
            prev = q + 1
        parts.append(str(m_l[t] - prev))
        md_l[t] = "".join(parts)
        pos_ev += cnt

    rep_amb = cfg.report_ambiguous
    FLAG_REV = K.FLAG_REVERSE
    for t, k in enumerate(f):
        i = rows[k]
        if not in_contig_l[t]:
            continue
        if amb_l[t] and not rep_amb:
            continue
        mapq = mapq_l[t]
        if mapq_overrides and mapq_overrides[i] is not None:
            mapq = mapq_overrides[i]
        m = m_l[t]
        qual = quals[i]
        rv = rev_l[t]
        xr, xg = tags_l[t]
        base = t * m_max
        out[i] = SamRecord(
            qnames[i],
            (FLAG_REV if rv else 0) | (flag_extras[i] if flag_extras else 0),
            names[ci_l[t]],
            coord_l[t] + 1,
            mapq,
            f"{m}M",
            "*", 0, 0,
            seq_str[base:base + m],
            (qual[::-1] if rv else qual) if qual else "*",
            nm_l[t],
            md_l[t],
            xm_str[base:base + m],
            xr, xg,
        )
    return out
