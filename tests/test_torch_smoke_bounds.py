"""chip_smoke.py's bounds: the INT32-pipe instruction counts it reads from a
cuobjdump listing of the built kernels, and the roofline it makes of them.

The listing below is synthetic and has the shapes the real ones have: two
kernels, a column loop inside an outer loop, predicated instructions, the
second (encoding) line of an instruction, a kernel's closing self-branch."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

LISTING = """
Fatbin elf code:
================
	code for sm_90a
		Function : _ZN37_GLOBAL__N__0_9_verify_cu_012myers_kernelILi3EEEvPKj
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe20000000800 */
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;                   /* 0x0000000102027810 */
                                                                             /* 0x000fe20007ffe0ff */
        /*0020*/                   LOP3.LUT R3, R3, R4, RZ, 0xc0, !PT ;      /* 0x0 */
        /*0030*/                   SHF.L.U32 R5, R5, 0x1, RZ ;               /* 0x0 */
        /*0040*/                   IMAD R6, R6, R7, R8 ;                     /* 0x0 */
        /*0050*/                   @P0 SEL R9, R9, R10, P0 ;                 /* 0x0 */
        /*0060*/                   @!P1 BRA 0x30 ;                           /* 0x0 */
        /*0070*/                   POPC R2, R3 ;                             /* 0x0 */
        /*0080*/                   LDG.E R4, desc[UR4][R2.64] ;              /* 0x0 */
        /*0090*/                   @P2 BRA 0x20 ;                            /* 0x0 */
        /*00a0*/                   ISETP.GE.AND P0, PT, R0, R1, PT ;         /* 0x0 */
        /*00b0*/                   UIADD3 UR4, UR4, 0x1, URZ ;               /* 0x0 */
        /*00c0*/                   EXIT ;                                    /* 0x0 */
        /*00d0*/                   BRA 0xd0;                                 /* 0x0 */
        /*00e0*/                   NOP;                                      /* 0x0 */
		..........
		Function : _ZN37_GLOBAL__N__0_9_verify_cu_017myers_scan_kernelILi3EEEvPKj
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   VIMNMX R1, R1, R2, PT ;                   /* 0x0 */
        /*0010*/                   LEA R2, R2, R3, 0x2 ;                     /* 0x0 */
        /*0020*/                   STG.E desc[UR4][R2.64], R1 ;              /* 0x0 */
        /*0030*/                   @P0 BRA 0x10 ;                            /* 0x0 */
        /*0040*/                   EXIT ;                                    /* 0x0 */
		..........
		Function : _ZN37_GLOBAL__N__0_9_verify_cu_08straightEv
        /*0000*/                   IADD3 R2, R2, 0x1, RZ ;                   /* 0x0 */
        /*0010*/                   EXIT ;                                    /* 0x0 */
        /*0020*/                   BRA 0x20;                                 /* 0x0 */
"""


@pytest.mark.parametrize("function, want", [
    # innermost loop 0x30-0x60: SHF and the predicated SEL (IMAD goes to the
    # FMA pipe); outside 0x20-0x90: IADD3 and ISETP (LDC, UIADD3 are not of
    # the INT32 pipe)
    ("12myers_kernelILi3E", {"loop": 2, "once": 2}),
    ("myers_scan_kernelILi3E", {"loop": 1, "once": 1}),
])
def test_counts_of_a_listing(function, want):
    assert chip_smoke.sass_int32_ops(LISTING, function) == want


@pytest.mark.parametrize("function", [
    "fm_search_kernel",        # not in the listing
    "kernelILi3E",             # two kernels carry it
    "8straightEv",             # no loop: the closing self-branch is none
])
def test_counter_refuses(function):
    with pytest.raises(AssertionError):
        chip_smoke.sass_int32_ops(LISTING, function)


SPILL_LISTING = """
		Function : _ZN37_GLOBAL__N__0_9_verify_cu_031verify_fused_gather_wide_kernelILi5ELb0EEEvPKj
        /*0000*/                   STL [R1], R2 ;                            /* 0x0 */
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;                   /* 0x0 */
        /*0020*/                   VOTE.ANY R3, PT, P0 ;                     /* 0x0 */
        /*0030*/                   @P0 BRA 0x10 ;                            /* 0x0 */
        /*0040*/                   LDL R2, [R1] ;                            /* 0x0 */
        /*0050*/                   @P1 BRA 0x40 ;                            /* 0x0 */
        /*0060*/                   LDL R4, [R1+0x4] ;                        /* 0x0 */
        /*0070*/                   EXIT ;                                    /* 0x0 */
        /*0080*/                   BRA 0x80;                                 /* 0x0 */
"""


def test_local_memory_in_loops():
    """A spill store before the loops and a reload after them are not in a
    loop; the reload inside the loop 0x40-0x50 is."""
    assert chip_smoke.sass_local_in_loops(SPILL_LISTING,
                                          "wide_kernelILi5ELb0E") == 1


@pytest.mark.parametrize("regs, smem, warps", [
    (64, 12_804, 32),      # the register file: 8 blocks of 4 warps
    (96, 21_000, 20),      # 5 blocks
    (63, 31_248, 28),      # shared memory: 7 blocks
    (99, 82_448, 8),       # shared memory: 2 blocks
    (32, 0, 64),           # the warp limit
])
def test_resident_warps(regs, smem, warps):
    assert chip_smoke.resident_warps(regs, smem) == warps


def test_every_kernel_has_a_listing_name():
    # the two row gathers, the pair join and the four flat-buffer kernels
    # are bound by bytes: no operation count
    assert set(chip_smoke.SASS_KERNELS) == set(chip_smoke.KERNEL_SOURCES) \
        - {"gather_rows", "gather_rows_shard", "pair_join", "flat_expand",
           "flat_dedup", "scatter_back", "select_se"}
    assert all(lib in ("verify", "fm")
               for lib, _ in chip_smoke.SASS_KERNELS.values())


def test_rescue_passes_have_their_own_listing_names():
    """The one-pass kernel and the two passes are three instances of one
    template: each name picks out exactly one of them."""
    names = [chip_smoke.SASS_KERNELS["rescue_scan"][1]] + [
        f for _, f in chip_smoke.SASS_PASSES.values()]
    assert len(set(names)) == 3
    for a in names:
        assert sum(a in b for b in names) == 1, a


@pytest.mark.parametrize("nbytes, ops, by", [
    (3.35e9, 16.75e9 / 2, "bytes"),          # 1 ms against 0.5 ms
    (3.35e9 / 2, 16.75e9, "operations"),
])
def test_bound_takes_the_larger(nbytes, ops, by):
    b = chip_smoke.bound(nbytes, ops)
    assert b["bound_by"] == by
    assert b["bound_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("words, scale", [(3, 1.0), (9, 3.0)])
def test_verify_ops_scale_with_the_words(monkeypatch, words, scale):
    monkeypatch.setitem(chip_smoke.SASS_OPS, "verify_fused_gather",
                        {"loop": 48, "once": 93})
    got = chip_smoke.verify_ops("verify_fused_gather", lanes=1000,
                                myers_lanes=400, ncols=104, words=words)
    assert got == pytest.approx((1000 * 93 + 400 * 104 * 48) * scale)


@pytest.mark.parametrize("chunks", [1, 2, 8, 32])
def test_rescue_columns_run_counts_the_warm_up(chunks):
    """rescue_columns_run counts the columns the kernel runs with `chunks`
    threads per pair, warm-up included, as the scalar model of the kernel
    does on lanes with full, short, zero, negative and missing spans; with
    one thread it is the columns the function needs, which the bound
    charges."""
    import numpy as np

    from test_torch_rescue_scan import (rescue_lanes, rescue_pair_model,
                                        toy_genome)
    from bitmapperbs_tpu_torch.index.device import _device_layout_planes

    m, e, R, n = 32, 3, 61, 40
    rng = np.random.default_rng(9)
    genome = toy_genome(rng)
    gp = _device_layout_planes(genome)
    ln = rescue_lanes(rng, n, m, e, R, genome)
    zeros = [[0] * (m // 32)] * 4
    want = sum(rescue_pair_model(
        gp, gp.shape[0] // 2, genome.length, int(ln["blk"][i]),
        int(ln["win_start"][i]), bool(ln["r_ok"][i]), int(ln["a_lo"][i]),
        int(ln["span"][i]), int(ln["lens"][i]), zeros, zeros[0], m, e, R,
        chunks)[3] for i in range(n))
    got = chip_smoke.rescue_columns_run(ln["r_ok"], ln["span"], m, e, R,
                                        chunks)
    assert got == want > 0
    # one thread per pair: the window's columns up to the last valid one
    if chunks == 1:
        span = ln["span"].astype(np.int64)
        span[span >= 1 << 31] = -1
        full = np.where(ln["r_ok"] & (span >= 0),
                        e + m + np.minimum(span, R + e), 0)
        assert got == full.sum()


def test_every_tpu_kernel_names_its_entries():
    """Every entry stands for a TPU kernel or is one with no TPU kernel
    behind it, never both: the pair join and the compact candidate stage's
    flat buffer are the reference's plain jnp."""
    named = [n for names in chip_smoke.TPU_KERNEL_ENTRIES.values()
             for n in names]
    none = list(chip_smoke.NO_TPU_KERNEL_ENTRIES)
    assert not set(named) & set(none)
    assert sorted(named + none) == sorted(chip_smoke.KERNEL_SOURCES)
    assert "rescue_scan" in chip_smoke.TPU_KERNEL_ENTRIES["myers_scan_pallas"]
    assert "paired.py:220-238" in chip_smoke.KERNEL_SOURCES["rescue_scan"][1]
    assert none == ["pair_join", "flat_expand", "flat_dedup", "scatter_back",
                    "select_se"]
    assert "bitmapperbs_tpu/models/paired.py:80-145" in \
        chip_smoke.KERNEL_SOURCES["pair_join"][1]
    for name, lines in (("flat_expand", "111-120 and 366-406"),
                        ("flat_dedup", "421-437"),
                        ("scatter_back", "490-515"),
                        ("select_se", "520-548")):
        assert chip_smoke.KERNEL_SOURCES[name] == (
            "bitmapperbs_tpu_torch/csrc/flat.cu",
            f"bitmapperbs_tpu/models/aligner.py:{lines} (plain jnp under "
            f"jax.jit: no Pallas kernel)")
    assert chip_smoke.KERNEL_SOURCES["pair_join"][0].endswith("csrc/pair.cu")


@pytest.mark.parametrize("B, F1, F2, Kc, ms", [
    # the Gbp PE cell: 4,096 pairs, 2 + 2 frames, Kc 128: 25.48 MB
    (4096, 2, 2, 128, 0.0076051),
    # PBAT at Kc 256: 8 frames of 256 slots a pair
    (4096, 4, 4, 256, 0.0301417),
])
def test_pair_join_bound_counts_its_bytes(B, F1, F2, Kc, ms):
    """Each slot's int32 score and int64 anchor read once, the two int64
    lengths read once, three int32 and six int64 outputs written once; bound
    by bytes (the bound takes no operation count)."""
    n = chip_smoke.pair_join_bytes(B, F1, F2, Kc)
    assert n == B * ((F1 + F2) * Kc * 12 + 16 + 60)
    b = chip_smoke.bound(n, 0)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(ms, rel=1e-4)


@pytest.mark.parametrize("broadcast", [True, False])
def test_select_bound_counts_the_finite_cells(broadcast):
    """Every int32 score read; the fwd and frame anchors (and the bp code,
    unless broadcast per frame) of the cells with a finite score only, and
    of every cell of a read that has none; four outputs per read."""
    torch = pytest.importorskip("torch")
    from bitmapperbs_tpu_torch.constants import INF_SCORE as INF
    B, F, Kc = 3, 2, 4
    score = torch.full((B, F, Kc), INF, dtype=torch.int32)
    score[0, 0, 1], score[0, 1, 3], score[2, 1, 0] = 3, 0, 4   # read 1: none
    bp = torch.tensor([0, 3], dtype=torch.int64)[None, :, None]
    bp = bp.expand(B, F, Kc) if broadcast else bp.repeat(B, 1, Kc)
    grids = {"score": score, "bp": bp}
    need = 2 + F * Kc + 1
    want = B * F * Kc * 4 + need * 16 + (F if broadcast else need) * 8 \
        + B * 24
    assert chip_smoke.flat_bytes("select_se", (grids, 4)) == want


def test_scatter_back_bound_counts_the_landing_lanes():
    """The keep byte of each lane of a row < R, the score of each kept lane,
    the key and rank of each that lands (score <= e), the lengths, and the
    three grids written once."""
    torch = pytest.importorskip("torch")
    B, blocks, Kc, e = 2, (0, 1), 3, 4
    R = B * len(blocks)
    rows = torch.tensor([0, 0, 1, 3, 3, R, R, R])
    keyS = rows << 32 | torch.arange(8)
    keep = torch.tensor([1, 0, 1, 1, 1, 0, 0, 0], dtype=torch.bool)
    score = torch.tensor([2, 9, 5, 0, 4, 0, 0, 0], dtype=torch.int32)
    args = (keyS, keep, None, score, torch.tensor([90, 80]), blocks, 10**6,
            e, Kc)
    want = 5 + 4 * 4 + 3 * 16 + B * 8 + R * Kc * 20
    assert chip_smoke.flat_bytes("scatter_back", args) == want


def test_trimmed_length_model():
    """Phase 13b's lengths: TRIM_MIN..TRIM_READ_LEN, the untrimmed share
    near `keep`."""
    import numpy as np

    rng = np.random.default_rng(0)
    for keep in chip_smoke.TRIM_KEEPS:
        lens = chip_smoke.trimmed_lengths(rng, 100_000, keep)
        assert lens.min() >= chip_smoke.TRIM_MIN
        assert lens.max() == chip_smoke.TRIM_READ_LEN
        assert abs((lens == chip_smoke.TRIM_READ_LEN).mean() - keep) < 0.01


def _chunks(*mins, fill=150):
    """One chunk of GBP_BATCH lengths per entry, all `fill` but the first,
    which is the entry."""
    import numpy as np

    out = np.full(len(mins) * chip_smoke.GBP_BATCH, fill, np.int64)
    out[::chip_smoke.GBP_BATCH] = mins
    return out


@pytest.mark.parametrize("lens1, lens2, rate, want", [
    ((150, 150), None, None, (1, 1.0)),
    ((20, 24), None, None, (1, 1.0)),       # one quotient of num_seeds 5
    ((20, 25), None, None, (2, 1.0)),
    ((20, 20), (150, 30), None, (2, 1.0)),  # mate 2's quotient differs
    ((150, 150), None, 0.04, (1, 1.0)),     # one budget: 6
    ((20, 150), None, 0.04, (1, 0.5)),      # a chunk of two budgets: eager
    ((150, 150), (150, 20), 0.04, (2, 1.0)),  # a pair: its larger budget
])
def test_trimmed_keys_as_the_cli_groups(lens1, lens2, rate, want):
    """trimmed_keys counts the graph keys of the CLI's full batches: one
    per (config group, min_read_len // num_seeds per mate), none for a
    chunk that the budgets split."""
    from bitmapperbs_tpu_torch.config import AlignerConfig

    cfg = AlignerConfig(max_errors=4, read_len_bucket=chip_smoke.TRIM_BUCKET,
                        batch_size=chip_smoke.GBP_BATCH)
    got = chip_smoke.trimmed_keys(
        cfg, _chunks(*lens1), None if lens2 is None else _chunks(*lens2),
        rate)
    assert got == want
