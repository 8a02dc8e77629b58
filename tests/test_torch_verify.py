"""PyTorch port: verification ops and the kernels' plain versions equal the
JAX reference (ops/verify.py, the fused Pallas kernel in interpret mode)
exactly, on the same seeded random lanes."""
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


def T(a):
    """numpy (u32 or int) -> torch int64 lanes."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=msg)


def random_case(rng, n, m, e, ww):
    """Random window/read lanes mixing near-matches (ham <= e), bisulfite
    conversions, indels, N codes and short reads."""
    win = rng.integers(0, 4, (n, ww * 32)).astype(np.uint8)
    reads = np.full((n, m), K.N_CODE, np.uint8)
    lens = rng.integers(m // 2, m + 1, n).astype(np.int32)
    for i in range(n):
        r = win[i, e:e + lens[i]].copy()
        r[(r == K.C) & (rng.random(len(r)) < 0.7)] = K.T
        for _ in range(int(rng.integers(0, 2 * e + 3))):
            p = int(rng.integers(0, len(r)))
            op = rng.integers(0, 3)
            if op == 0:
                r[p] = rng.integers(0, 5)
            elif op == 1:
                r = np.delete(r, p)
            else:
                r = np.insert(r, p, rng.integers(0, 4))
        r = r[:lens[i]]
        lens[i] = len(r)
        reads[i, :len(r)] = r
    win[rng.random(win.shape) < 0.01] = K.N_CODE
    return win, reads, lens


def test_pack_codes_and_length_mask(rng):
    codes = rng.integers(0, 5, (7, 3, 96)).astype(np.uint8)
    for got, want in zip(tv.pack_codes(torch.from_numpy(codes)),
                         jv.pack_codes(jnp.asarray(codes))):
        same(got, want)
    lens = rng.integers(0, 97, (7, 3)).astype(np.int32)
    same(tv.length_mask(torch.from_numpy(lens), 96),
         jv.length_mask(jnp.asarray(lens), 96))


@pytest.mark.parametrize("nwords", [3, 4])
def test_window_planes(rng, nwords):
    genome = parse_fasta(random_genome_fasta(rng, contigs=(700, 300)))
    L = genome.length
    gp = _device_layout_planes(genome)
    n = 400
    starts = rng.integers(0, L, n).astype(np.uint64)
    starts[:40] = (1 << 32) - rng.integers(1, 33, 40)     # wrapped below 0
    starts[40:80] = L - rng.integers(-40, 130, 40)        # runs past the end
    starts[80:90] = np.arange(10)
    orient = rng.integers(0, 2, n).astype(np.int32)
    got = tv.window_planes(torch.from_numpy(gp.view(np.int32)),
                           torch.from_numpy(orient), T(starts), nwords, L)
    want = jv.window_planes(jnp.asarray(gp), jnp.asarray(orient),
                            jnp.asarray(starts.astype(np.uint32)), nwords, L)
    for p, (g, w) in enumerate(zip(got, want)):
        same(g, w, f"plane {p}")


def test_hamming_and_peq(rng):
    n, m = 300, 96
    ref = rng.integers(0, 5, (n, m)).astype(np.uint8)
    reads = rng.integers(0, 5, (n, m)).astype(np.uint8)
    lens = rng.integers(30, m + 1, n).astype(np.int32)
    rp_t = tv.pack_codes(torch.from_numpy(reads))
    fp_t = tv.pack_codes(torch.from_numpy(ref))
    lm_t = tv.length_mask(torch.from_numpy(lens), m)
    rp_j = jv.pack_codes(jnp.asarray(reads))
    fp_j = jv.pack_codes(jnp.asarray(ref))
    lm_j = jv.length_mask(jnp.asarray(lens), m)
    same(tv.hamming(fp_t, rp_t, lm_t), jv.hamming(fp_j, rp_j, lm_j))
    peq_t, pad_t = tv.build_peq(torch.from_numpy(reads),
                                torch.from_numpy(lens), m)
    peq_j, pad_j = jv.build_peq(jnp.asarray(reads), jnp.asarray(lens), m)
    same(peq_t, peq_j, "peq")
    same(pad_t, pad_j, "pad")


@pytest.mark.parametrize("e", [2, 4])
def test_myers(rng, e):
    n, m = 160, 96
    ncols = m + 2 * e
    ww = -(-ncols // 32)
    win, reads, lens = random_case(rng, n, m, e, ww)
    wp_j = jv.pack_codes(jnp.asarray(win))
    peq_j, pad_j = jv.build_peq(jnp.asarray(reads), jnp.asarray(lens), m)
    want = jv.myers(wp_j, peq_j, pad_j, m, ncols)
    wp_t = tv.pack_codes(torch.from_numpy(win))
    peq_t, pad_t = tv.build_peq(torch.from_numpy(reads),
                                torch.from_numpy(lens), m)
    same(tv.myers(wp_t, peq_t, pad_t, m, ncols), want)
    # the dense path's broadcast layout: PEQ/pad per read, windows per lane
    B, Kc = 8, n // 8
    wp_b = tuple(p.reshape(B, 1, Kc, ww) for p in wp_t)
    got = kernels.myers_ref(wp_b, peq_t[:B, None, None], pad_t[:B, None, None],
                            m, ncols)
    want_b = jv.myers(tuple(p.reshape(B, 1, Kc, ww) for p in wp_j),
                      jnp.broadcast_to(peq_j[:B, None, None],
                                       (B, 1, Kc, 4, 3)),
                      jnp.broadcast_to(pad_j[:B, None, None], (B, 1, Kc, 3)),
                      m, ncols)
    same(got, want_b, "broadcast")


def _fused_inputs(rng, n, m, e):
    Wd = m // 32
    ww = max(-(-(m + 2 * e) // 32), Wd + 1)
    win, reads, lens = random_case(rng, n, m, e, ww)
    return (tv.pack_codes(torch.from_numpy(win)),
            tv.pack_codes(torch.from_numpy(reads)),
            tv.length_mask(torch.from_numpy(lens), m),
            jv.pack_codes(jnp.asarray(win)), jv.pack_codes(jnp.asarray(reads)),
            jv.length_mask(jnp.asarray(lens), m))


def test_verify_fused_ref_vs_pallas_interpret(rng):
    """The plain version equals the Pallas kernel itself, run in interpret
    mode at the reference's own small ungated size."""
    from bitmapperbs_tpu.ops.pallas_kernels import verify_fused_pallas
    m = 32
    for e in (2, 0):
        wt, rt, lt, wj, rj, lj = _fused_inputs(rng, 8, m, e)
        want = verify_fused_pallas(wj, rj, lj, m, m + 2 * e, e,
                                   interpret=True)
        same(kernels.verify_fused_ref(wt, rt, lt, m, m + 2 * e, e), want,
             f"e={e}")


def test_verify_fused_ref_vs_jnp_sequence(rng):
    """At the main path's widths (m = 96, e = 4): the jnp hamming/PEQ/Myers
    sequence the compact path runs on the CPU."""
    m, e, Wd = 96, 4, 3
    ncols = m + 2 * e
    wt, rt, lt, wj, rj, lj = _fused_inputs(rng, 512, m, e)
    ham = jv.hamming(_shift_planes(wj, e, Wd), rj, lj)
    peq = _peq_from_planes(*rj, ~lj)
    want = jnp.where(ham <= e, ham, jv.myers(wj, peq, ~lj, m, ncols))
    got = kernels.verify_fused_ref(wt, rt, lt, m, ncols, e)
    same(got, want)
    assert got.dtype == torch.int32
    hams = np.asarray(ham)
    assert (hams <= e).any() and (hams > e).any()


def test_wrappers_take_plain_path_on_cpu(rng):
    m, e = 96, 4
    wt, rt, lt, *_ = _fused_inputs(rng, 64, m, e)
    before = dict(kernels.LAUNCHES)
    peq, pad = tv.peq_from_planes(*rt, ~lt & 0xFFFFFFFF)
    same(kernels.myers(wt, peq, pad, m, m + 2 * e),
         kernels.myers_ref(wt, peq, pad, m, m + 2 * e))
    assert kernels.LAUNCHES == before          # no kernel ran
    with pytest.raises(ValueError):            # no silent mixed-device path
        kernels.myers(tuple(p.to("meta") for p in wt), peq, pad, m,
                      m + 2 * e)
