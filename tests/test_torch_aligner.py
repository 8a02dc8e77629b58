"""PyTorch port: map_batch_device (best, second) tuples equal the JAX CPU
map_batch_device's in every pipeline configuration, and the port's host
loop writes SAM byte-identical to the reference's and the oracle's, taken
to their SAM v1 form (tests/sam_v1.py); the reads are of the directional
strands, so the form changes none of them, PBAT configurations included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index as jupload  # noqa: E402
from bitmapperbs_tpu.models import aligner as jal  # noqa: E402
from bitmapperbs_tpu.models.host import map_batch_tpu  # noqa: E402
from bitmapperbs_tpu.oracle.pipeline import map_batch_se  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            repeat_genome_fasta,
                                            simulate_reads)
from bitmapperbs_tpu_torch.index.device import upload_index  # noqa: E402
from bitmapperbs_tpu_torch.models import aligner as tal  # noqa: E402
from bitmapperbs_tpu_torch.models.host import (map_batch,  # noqa: E402
                                               prepare_batch)
from sam_v1 import sam_v1  # noqa: E402


def v1(idx, recs) -> list[str]:
    """The JAX package's SE records as SAM v1 lines: none of these tests'
    records changes."""
    lines, changed = sam_v1([r.line() for r in recs], idx.genome,
                            paired=False)
    assert changed == 0
    return lines

B = 48
BASE = AlignerConfig(max_errors=4, indels=True, read_len_bucket=96,
                     batch_size=B)
CONFIGS = {
    "a_compact": BASE,
    # dense spec path (same config the gdrop fallback of "f" re-runs)
    "b_dense": BASE.replace(locate_flat_cap=1, compact=False),
    "c_e0": BASE.replace(max_errors=0),
    "d_hamming_only": BASE.replace(max_errors=3, indels=False),
    "e_chunks_pbat": BASE.replace(flat_chunks=2, non_directional=True),
    "f_gdrop": BASE.replace(locate_flat_cap=1),
}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    idx = build_index(random_genome_fasta(rng, contigs=(5000, 2000)))
    sims = simulate_reads(idx.genome, B, read_len=90, seed=32, sub_rate=0.01,
                          indel_rate=0.005)
    cut = np.random.default_rng(5).integers(50, 91, B)
    reads = [s.codes[:c] if i % 4 == 0 else s.codes
             for i, (s, c) in enumerate(zip(sims, cut))]
    return idx, jupload(idx), upload_index(idx), reads, [s.qual for s in sims]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_map_batch_device_matches_jax(setup, name):
    idx, jd, td, reads, _ = setup
    cfg = CONFIGS[name]
    arr, lens = prepare_batch(reads, 96, B)
    want = jal.map_batch_device(jd, cfg, jnp.asarray(arr), jnp.asarray(lens))
    got = tal.map_batch_device(td, cfg, torch.from_numpy(arr),
                               torch.from_numpy(lens))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    mapped = int((got["best_score"] < (1 << 20)).sum())
    assert mapped > (B // 2 if name in ("a_compact", "b_dense",
                                        "e_chunks_pbat") else 0)
    if name == "f_gdrop":
        assert got["gdrop"].any()


@pytest.mark.parametrize("name", ["a_compact", "b_dense"])
def test_map_batch_device_host_min_len(setup, name):
    """Given the batch's shortest read length (as the host loop passes it),
    seeding skips its short-slice phase and the tuples still equal the
    reference's."""
    idx, jd, td, reads, _ = setup
    cfg = CONFIGS[name]
    arr, lens = prepare_batch(reads, 96, B)
    assert int(lens.min()) // cfg.num_seeds >= td.klt_k   # phase skipped
    want = jal.map_batch_device(jd, cfg, jnp.asarray(arr), jnp.asarray(lens))
    got = tal.map_batch_device(td, cfg, torch.from_numpy(arr),
                               torch.from_numpy(lens),
                               min_read_len=int(lens.min()))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)


@pytest.mark.parametrize("name", ["a_compact", "f_gdrop"])
def test_map_batch_sam_matches_reference_and_oracle(setup, name):
    idx, jd, td, reads, quals = setup
    cfg = CONFIGS[name]
    got = [r.line() for r in map_batch(idx, td, cfg, reads, quals)]
    ref = v1(idx, map_batch_tpu(idx, jd, cfg, reads, quals))
    oracle = v1(idx, map_batch_se(idx, cfg, reads, quals))
    assert got == ref
    assert got == oracle


def test_compact_equals_dense_grids(setup):
    """The port keeps the reference's invariant: compact grids equal the
    dense spec grids for reads without gdrop."""
    idx, _, td, reads, _ = setup
    arr, lens = prepare_batch(reads, 96, B)
    a, ln = torch.from_numpy(arr), torch.from_numpy(lens).long()
    frames = tuple(tal.se_frames(BASE))
    gd = tal.candidate_grids(td, BASE, a, ln, frames)
    gc = tal.candidate_grids_compact(td, BASE, a, ln, frames)
    assert not gc["gdrop"].any()
    for k in ("score", "fwd", "frame_a", "bp", "overflow"):
        assert torch.equal(gd[k], gc[k]), k


# ---- the Gbp-scale configuration on a repeat-structured genome ---------------

# what cli.autotune_for_genome sets above 512 Mbp: adaptive seed extension
# and 128 verified anchors per frame
GBP = BASE.replace(seed_ext_max=20, seed_ext_occ=4, max_candidates=128)
GBP_CONFIGS = {
    "gbp": GBP,
    "gbp_chunks": GBP.replace(flat_chunks=2),
    "gbp_pbat": GBP.replace(non_directional=True),
    "gbp_gdrop": GBP.replace(locate_flat_cap=1),
}


@pytest.fixture(scope="module")
def repeat_setup():
    """Planted dispersed / LINE-like / tandem repeats (plant_repeats
    defaults); half of the reads are simulated over the whole genome, so
    many start inside repeat copies, and a quarter are short."""
    rng = np.random.default_rng(77)
    idx = build_index(repeat_genome_fasta(rng, contigs=(40000, 20000)))
    sims = simulate_reads(idx.genome, B, read_len=90, seed=78, sub_rate=0.01,
                          indel_rate=0.005)
    cut = np.random.default_rng(6).integers(50, 91, B)
    reads = [s.codes[:c] if i % 4 == 0 else s.codes
             for i, (s, c) in enumerate(zip(sims, cut))]
    return idx, jupload(idx), upload_index(idx), reads, [s.qual for s in sims]


def test_gbp_extension_moves_seeds(repeat_setup):
    """On this genome the extension is not a no-op: heavy seeds grow, and
    their starts move left with them."""
    idx, _, td, reads, _ = repeat_setup
    arr, lens = prepare_batch(reads, 96, B)
    a, ln = torch.from_numpy(arr), torch.from_numpy(lens).long()
    frames = tuple(tal.se_frames(GBP))
    plain = tal._seed_stage(td, BASE, a, ln, frames)
    ext = tal._seed_stage(td, GBP, a, ln, frames)
    moved = ext[3] < plain[3]
    assert moved.any()
    shrunk = (ext[5] - ext[4]) < (plain[5] - plain[4])
    assert (shrunk == moved).all()
    assert ((ext[5] - ext[4])[moved] > 0).all()    # never extended to empty


@pytest.mark.parametrize("name", sorted(GBP_CONFIGS))
def test_gbp_config_matches_jax(repeat_setup, name):
    idx, jd, td, reads, _ = repeat_setup
    cfg = GBP_CONFIGS[name]
    arr, lens = prepare_batch(reads, 96, B)
    want = jal.map_batch_device(jd, cfg, jnp.asarray(arr), jnp.asarray(lens))
    got = tal.map_batch_device(td, cfg, torch.from_numpy(arr),
                               torch.from_numpy(lens),
                               min_read_len=int(lens.min()))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    mapped = int((got["best_score"] < (1 << 20)).sum())
    if name == "gbp_gdrop":      # the host re-runs the dropped reads dense
        assert got["gdrop"].any()
    else:
        assert mapped > B // 2


@pytest.mark.parametrize("name", sorted(GBP_CONFIGS))
def test_gbp_config_sam_matches_reference_and_oracle(repeat_setup, name):
    idx, jd, td, reads, quals = repeat_setup
    cfg = GBP_CONFIGS[name]
    got = [r.line() for r in map_batch(idx, td, cfg, reads, quals)]
    ref = v1(idx, map_batch_tpu(idx, jd, cfg, reads, quals))
    oracle = v1(idx, map_batch_se(idx, cfg, reads, quals))
    assert got == ref
    assert got == oracle


# ---- reads over 256 bp: more than 8 plane words ------------------------------

@pytest.mark.parametrize("bucket,read_len,pbat", [(288, 280, False),
                                                  (288, 270, True),
                                                  (512, 500, False)])
def test_long_bucket_sam_matches_reference_and_oracle(bucket, read_len, pbat):
    """A batch in a bucket of 9 (and 16) plane words, some reads short,
    through the Gbp-scale configuration with indels: the compact path hands
    it to the gathering verify like any other bucket, and the SAM equals
    map_batch_tpu's and the oracle's."""
    n = 12
    idx = build_index(random_genome_fasta(np.random.default_rng(41),
                                          contigs=(6000, 2500)))
    cfg = GBP.replace(read_len_bucket=bucket, batch_size=n,
                      non_directional=pbat)
    sims = simulate_reads(idx.genome, n, read_len=read_len, seed=42,
                          sub_rate=0.004, indel_rate=0.002)
    reads = [s.codes[:read_len - 40] if i % 4 == 0 else s.codes
             for i, s in enumerate(sims)]
    quals = [s.qual[:len(r)] for s, r in zip(sims, reads)]
    got = [r.line() for r in map_batch(idx, upload_index(idx), cfg, reads,
                                       quals)]
    ref = v1(idx, map_batch_tpu(idx, jupload(idx), cfg, reads, quals))
    assert got == ref
    assert got == v1(idx, map_batch_se(idx, cfg, reads, quals))
    mapped = sum(not int(ln.split("\t")[1]) & 4 for ln in got)
    assert mapped > n // 2
