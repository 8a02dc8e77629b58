"""PyTorch port: device index upload equals the JAX reference's, bit for
bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bitmapperbs_tpu.index import device as jdev  # noqa: E402
from bitmapperbs_tpu.index.build import (build_index, load_index,  # noqa: E402
                                         save_index)
from bitmapperbs_tpu.utils.simulate import random_genome_fasta  # noqa: E402
from bitmapperbs_tpu_torch.index import device as tdev  # noqa: E402
from bitmapperbs_tpu_torch.ops import u32  # noqa: E402

FIELDS = ("cp_rows", "cbase", "sa_samples", "n", "g_planes", "klt")
STATIC = ("rows_max", "genome_len", "samples_max", "sa_rate", "klt_k",
          "g_words")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    idx = build_index(random_genome_fasta(rng, contigs=(5000, 2000)))
    return idx, jdev.upload_index(idx)


def as_u32(t):
    """Port tensor (int32 bits or int64 values) -> uint32 numpy."""
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def assert_same_index(jd, td):
    for f in FIELDS:
        want = np.asarray(getattr(jd, f))
        got = as_u32(getattr(td, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for s in STATIC:
        assert getattr(td, s) == getattr(jd, s), s


def test_upload_matches_jax(setup):
    idx, jd = setup
    td = tdev.upload_index(idx)
    assert_same_index(jd, td)
    assert td.cp_rows.dtype == torch.int32 and td.n.dtype == torch.int64


def test_from_arrays_matches_jax(setup):
    _, jd = setup
    td = tdev.from_arrays({f: np.asarray(getattr(jd, f)) for f in FIELDS},
                          **{s: getattr(jd, s) for s in STATIC})
    assert_same_index(jd, td)


def test_upload_from_artifact_shares_plane_cache(setup, tmp_path):
    """An mmap-loaded artifact uploads through the shared genome-plane cache
    file (the reference's format) and still equals the JAX upload."""
    idx, jd = setup
    prefix = str(tmp_path / "art")
    save_index(idx, prefix)
    idx2 = load_index(prefix)
    td = tdev.upload_index(idx2)            # writes the cache
    cache = tdev._planes_cache_path(idx2)
    assert cache == jdev._planes_cache_path(idx2)
    assert_same_index(jd, td)
    assert_same_index(jd, tdev.upload_index(idx2))   # reads the cache


def test_u32_helpers():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    t = torch.from_numpy(v.astype(np.int64))
    np.testing.assert_array_equal(u32.to_i32(t).numpy().view(np.uint32),
                                  v.astype(np.uint32))
    np.testing.assert_array_equal(u32.widen(u32.to_i32(t)).numpy(),
                                  v.astype(np.int64))
    want = np.array([bin(int(x)).count("1") for x in v])
    np.testing.assert_array_equal(u32.popcount(t).numpy(), want)
    np.testing.assert_array_equal(
        u32.bnot(t).numpy(), (~v.astype(np.uint32)).astype(np.int64))
    nb = torch.arange(-2, 36)
    np.testing.assert_array_equal(
        u32.mask_lt(nb).numpy(),
        [(1 << min(max(int(b), 0), 32)) - 1 for b in nb])
