"""PyTorch port: the fused verify with its window gather inside.  Its plain
version (what the wrapper runs on CPU tensors) equals the JAX package's
window_planes followed by its fused verify path, run as the JAX tests run it
on the CPU (the jnp sequence, and the Pallas kernel in interpret mode),
exactly, on lanes whose windows wrap below position 0, run past the genome
end, come from both orientations and carry short reads."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bitmapperbs_tpu import constants as K  # noqa: E402
from bitmapperbs_tpu.index.build import parse_fasta  # noqa: E402
from bitmapperbs_tpu.models.aligner import (_peq_from_planes,  # noqa: E402
                                            _shift_planes)
from bitmapperbs_tpu.ops import verify as jv  # noqa: E402
from bitmapperbs_tpu.utils.simulate import random_genome_fasta  # noqa: E402
from bitmapperbs_tpu_torch.index.device import \
    _device_layout_planes  # noqa: E402
from bitmapperbs_tpu_torch.ops import kernels  # noqa: E402
from bitmapperbs_tpu_torch.ops import verify as tv  # noqa: E402

U32 = 0xFFFFFFFF


def T(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=msg)


def lanes(rng, n, m, e, n_rows=37):
    """A toy genome's planes and n candidate lanes: reads cut at the anchor
    from either orientation with conversions, substitutions and small
    shifts (ham <= e and ham > e both occur), a table of n_rows read-plane
    rows that the lanes pick from, short reads, anchors within e of
    position 0 (the window start wraps) and within m of the end."""
    genome = parse_fasta(random_genome_fasta(rng, contigs=(900, 500)))
    L = genome.length
    gp = _device_layout_planes(genome)
    ref = np.stack([genome.codes, genome.rc_codes()])
    row = rng.integers(0, n_rows, n)
    orient_r = rng.integers(0, 2, n_rows)
    anchor_r = rng.integers(0, L - m, n_rows)
    anchor_r[:4] = rng.integers(0, e + 1, 4)
    anchor_r[4:8] = L - rng.integers(1, m, 4)
    lens_r = np.where(rng.random(n_rows) < 0.4,
                      rng.integers(m // 2, m + 1, n_rows), m - 6)
    pos = anchor_r[:, None] + np.arange(m)
    reads = ref[orient_r[:, None], np.clip(pos, 0, L - 1)]
    reads[pos >= L] = K.N_CODE
    reads[(reads == K.C) & (rng.random(reads.shape) < 0.7)] = K.T
    sub = rng.random(reads.shape) < rng.choice([0.0, 0.02, 0.08],
                                               n_rows)[:, None]
    reads[sub] = (reads[sub] + 1) % 4
    reads[np.arange(m)[None, :] >= lens_r[:, None]] = K.N_CODE
    # lanes: mostly at their row's anchor (sometimes shifted by an indel-like
    # offset), some anywhere
    orient = orient_r[row]
    anchor = anchor_r[row] + np.where(rng.random(n) < 0.3,
                                      rng.integers(-2, 3, n), 0)
    far = rng.random(n) < 0.2
    anchor[far] = rng.integers(0, L, far.sum())
    orient[far] = rng.integers(0, 2, far.sum())
    anchor[0], anchor[1] = e - 1, L - m // 2         # planted in every case
    start = (anchor - e) & U32                       # wraps for anchor < e
    assert (start >= 0xFFFFF000).any() and (anchor + m > L).any()
    return gp, L, reads.astype(np.uint8), lens_r, row, orient, start


@pytest.mark.parametrize("m,e", [(96, 4), (64, 2), (32, 3)])
def test_gathering_verify_ref_vs_jax_sequence(rng, m, e):
    n, Wd, ncols = 600, m // 32, m + 2 * e
    Ww = -(-ncols // 32)
    assert kernels.verify_fused_gather_fits(m, ncols)
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e)
    # the JAX compact path: window_planes, then hamming / PEQ / Myers
    wj = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient, jnp.int32),
                          jnp.asarray(start.astype(np.uint32)), Ww, L)
    rj = tuple(p[row] for p in jv.pack_codes(jnp.asarray(reads)))
    lj = jv.length_mask(jnp.asarray(lens_r[row], jnp.int32), m)
    ham = jv.hamming(_shift_planes(wj, e, Wd), rj, lj)
    want = jnp.where(ham <= e, ham,
                     jv.myers(wj, _peq_from_planes(*rj, ~lj), ~lj, m, ncols))
    hams = np.asarray(ham)
    assert (hams <= e).any() and (hams > e).any()
    # the port: planes table + per-lane row, no plane tensor in between
    tab = torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 3 * Wd)
    args = (torch.from_numpy(gp.view(np.int32)), T(orient), T(start), tab,
            T(row), T(lens_r[row]), L, gp.shape[0] // 2, m, ncols, e)
    before = dict(kernels.LAUNCHES)
    got = kernels.verify_fused_gather(*args)
    assert got.dtype == torch.int32 and kernels.LAUNCHES == before
    same(got, want)
    same(kernels.verify_fused_gather_ref(*args), want)


def test_gathering_verify_ref_vs_pallas_interpret(rng):
    """Against the Pallas kernel itself in interpret mode, at the
    reference's own small ungated size, fed by the JAX window gather."""
    from bitmapperbs_tpu.ops.pallas_kernels import verify_fused_pallas
    m, e, n = 32, 2, 8
    ncols = m + 2 * e
    gp, L, reads, lens_r, row, orient, start = lanes(rng, n, m, e, n_rows=8)
    wj = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient, jnp.int32),
                          jnp.asarray(start.astype(np.uint32)), 2, L)
    rj = tuple(p[row] for p in jv.pack_codes(jnp.asarray(reads)))
    lj = jv.length_mask(jnp.asarray(lens_r[row], jnp.int32), m)
    want = verify_fused_pallas(wj, rj, lj, m, ncols, e, interpret=True)
    tab = torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 3)
    same(kernels.verify_fused_gather(
        torch.from_numpy(gp.view(np.int32)), T(orient), T(start), tab, T(row),
        T(lens_r[row]), L, gp.shape[0] // 2, m, ncols, e), want)


def test_gathering_verify_widths_and_raises(rng):
    """The gathering entry is built for 1..8 read words and a window of one
    word more; other widths are the planes-taking entry's.  Device mixes and
    wrong lane types raise."""
    assert kernels.verify_fused_gather_fits(96, 104)
    assert kernels.verify_fused_gather_fits(256, 264)
    assert not kernels.verify_fused_gather_fits(288, 296)    # 9 words
    assert not kernels.verify_fused_gather_fits(96, 96)      # e = 0
    assert not kernels.verify_fused_gather_fits(96, 96 + 40)  # e = 20
    m, e = 96, 4
    gp, L, reads, lens_r, row, orient, start = lanes(rng, 32, m, e)
    tab = torch.stack(tv.pack_codes(torch.from_numpy(reads)), dim=1).reshape(
        len(reads), 9)
    g = torch.from_numpy(gp.view(np.int32))
    ok = [g, T(orient), T(start), tab, T(row), T(lens_r[row])]
    tail = (L, gp.shape[0] // 2, m, m + 2 * e, e)
    for i in (1, 2, 4, 5):
        bad = list(ok)
        bad[i] = bad[i].to(torch.int32)
        with pytest.raises(ValueError):
            kernels.verify_fused_gather(*bad, *tail)
    bad = list(ok)
    bad[0] = bad[0].to("meta")
    with pytest.raises(ValueError):
        kernels.verify_fused_gather(*bad, *tail)


def test_long_bucket_takes_the_planes_entry():
    """Reads over 256 bp (9 plane words) are past the gathering entry's
    compile-time widths: the compact path gathers their windows with
    window_planes and calls verify_fused, and the tuples still equal the
    JAX package's."""
    from bitmapperbs_tpu.config import AlignerConfig
    from bitmapperbs_tpu.index.build import build_index
    from bitmapperbs_tpu.index.device import upload_index as jupload
    from bitmapperbs_tpu.models import aligner as jal
    from bitmapperbs_tpu.utils.simulate import simulate_reads
    from bitmapperbs_tpu_torch.index.device import upload_index
    from bitmapperbs_tpu_torch.models import aligner as tal
    from bitmapperbs_tpu_torch.models.host import prepare_batch

    B, m = 12, 288
    cfg = AlignerConfig(max_errors=4, indels=True, read_len_bucket=m,
                        batch_size=B)
    idx = build_index(random_genome_fasta(np.random.default_rng(41),
                                          contigs=(5000, 2000)))
    sims = simulate_reads(idx.genome, B, read_len=280, seed=42,
                          sub_rate=0.004, indel_rate=0.001)
    arr, lens = prepare_batch([s.codes for s in sims], m, B)
    calls = []
    saved = (kernels.verify_fused, kernels.verify_fused_gather)
    kernels.verify_fused = lambda *a: calls.append("planes") or saved[0](*a)
    kernels.verify_fused_gather = \
        lambda *a: calls.append("gather") or saved[1](*a)
    try:
        got = tal.map_batch_device(upload_index(idx), cfg,
                                   torch.from_numpy(arr),
                                   torch.from_numpy(lens))
    finally:
        kernels.verify_fused, kernels.verify_fused_gather = saved
    assert calls == ["planes"]
    want = jal.map_batch_device(jupload(idx), cfg, jnp.asarray(arr),
                                jnp.asarray(lens))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    assert int((got["best_score"] < (1 << 20)).sum()) > B // 2
