"""PyTorch port, several devices in one process (parallel/mesh.py,
parallel/shard.py, index/device.upload_index_sharded): on a mesh of CPU
"devices", data-parallel and sharded-index mapping, SE and PE, give exactly
the JAX package's single-device tuples (the reference's own mesh tests,
tests/test_sharding.py, hold its shard_map path to the same); the sharded
tables are the reference's global sharded arrays byte for byte; the row-range
gather and the sharded fetches equal their replicated counterparts; the fused
kernels' wrappers take a sharded index (and refuse one they cannot take), the
mapping paths call them on it, and placing it needs peer access."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from bitmapperbs_tpu.config import AlignerConfig  # noqa: E402
from bitmapperbs_tpu.index.build import build_index  # noqa: E402
from bitmapperbs_tpu.index.device import upload_index as jupload  # noqa: E402
from bitmapperbs_tpu.models import aligner as jal  # noqa: E402
from bitmapperbs_tpu.models import paired as jpaired  # noqa: E402
from bitmapperbs_tpu.parallel.shard import \
    upload_index_sharded as jupload_sharded  # noqa: E402
from bitmapperbs_tpu.utils.simulate import (random_genome_fasta,  # noqa: E402
                                            simulate_pairs, simulate_reads)
from bitmapperbs_tpu_torch import constants as K  # noqa: E402
from bitmapperbs_tpu_torch.index.device import (Shards,  # noqa: E402
                                                upload_index,
                                                upload_index_sharded)
from bitmapperbs_tpu_torch.models.host import prepare_batch  # noqa: E402
from bitmapperbs_tpu_torch.ops import fm, kernels, verify  # noqa: E402
from bitmapperbs_tpu_torch.ops.u32 import wrap  # noqa: E402
from bitmapperbs_tpu_torch.parallel.mesh import (Mesh,  # noqa: E402
                                                 shard_batch)
from bitmapperbs_tpu_torch.parallel.shard import (  # noqa: E402
    make_cli_mappers, make_sharded_pe_mapper, make_sharded_se_mapper,
    upload_mesh_index)

from chip_smoke import straddling_pairs, tandem_genome_fasta  # noqa: E402

CPU = torch.device("cpu")
CFG = AlignerConfig(max_errors=3, indels=True, read_len_bucket=64,
                    batch_size=64)
EXT = CFG.replace(seed_ext_max=10, seed_ext_occ=2, max_candidates=16)


@pytest.fixture(scope="module")
def setup():
    """tests/test_sharding.py's setup, and the JAX package's single-device
    tuples for it."""
    rng = np.random.default_rng(31)
    idx = build_index(random_genome_fasta(rng, contigs=(8000, 3000)))
    sims = simulate_reads(idx.genome, 64, read_len=60, seed=7, sub_rate=0.01)
    reads, lengths = prepare_batch([s.codes for s in sims], 64, 64)
    jd = jupload(idx)
    want = {name: as_np(jal.map_batch_device(jd, cfg, jnp.asarray(reads),
                                             jnp.asarray(lengths)))
            for name, cfg in (("base", CFG), ("ext", EXT))}
    return idx, reads, lengths, want


def as_np(tree):
    return {k: as_np(v) if isinstance(v, dict)
            else np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            .astype(np.int64) for k, v in tree.items()}


def assert_same(got, want, path=""):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            assert_same(got[k], w, f"{path}{k}.")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}{k}")


def mesh_devices(n):
    return [CPU] * n


# ---- single end: data parallel, sharded index, split invariance ------------

@pytest.mark.parametrize("n", [2, 8])
def test_data_parallel_matches_reference(setup, n):
    idx, reads, lengths, want = setup
    m = make_cli_mappers(idx, CFG, mesh_devices(n))
    assert m.mesh.shape == {"data": n} and m.batch_round == n
    got = as_np(m.se(reads, lengths, int(lengths.min())))
    assert_same(got, want["base"])
    assert (got["best_score"] < (1 << 20)).sum() > 48


def test_sharded_index_matches_reference(setup):
    idx, reads, lengths, want = setup
    before = kernels.LAUNCHES["gather_rows_shard"]
    m = make_cli_mappers(idx, CFG, mesh_devices(8), shard_index=4)
    assert m.mesh.shape == {"data": 2, "idx": 4} and m.batch_round == 2
    assert all(d.sharded and len(d.cp_rows.parts) == 4 for d in m.dix)
    assert_same(as_np(m.se(reads, lengths)), want["base"])
    # the CPU tensors run the plain versions: no launch is counted
    assert kernels.LAUNCHES["gather_rows_shard"] == before


def test_sharded_index_with_seed_extension(setup):
    idx, reads, lengths, want = setup
    m = make_cli_mappers(idx, EXT, mesh_devices(8), shard_index=4)
    assert_same(as_np(m.se(reads, lengths)), want["ext"])


def test_flat_chunks_data_parallel(setup):
    idx, reads, lengths, want = setup
    m = make_cli_mappers(idx, CFG.replace(flat_chunks=8), mesh_devices(8))
    assert_same(as_np(m.se(reads, lengths)), want["base"])


@pytest.mark.parametrize("compact", [True, False])
def test_sharded_mapper_on_a_mesh(setup, compact):
    """make_sharded_se_mapper on tensors, a 4 x 2 mesh and the dense path
    (the gdrop re-run's mapper): the same tuples."""
    idx, reads, lengths, want = setup
    mesh = Mesh.grid(mesh_devices(8), 4, 2)
    fn = make_sharded_se_mapper(CFG.replace(compact=compact), mesh,
                                upload_mesh_index(idx, mesh))
    got = fn(torch.from_numpy(reads), torch.from_numpy(lengths))
    assert_same(as_np(got), want["base"])


def test_batch_split_invariance(setup):
    """The same reads in two batches of 32, each on a 2-slice sharded mesh,
    give the reference's tuples for the batch of 64."""
    idx, reads, lengths, want = setup
    m = make_cli_mappers(idx, CFG.replace(batch_size=32), mesh_devices(4),
                         shard_index=2)
    halves = [as_np(m.se(reads[lo:lo + 32], lengths[lo:lo + 32]))
              for lo in (0, 32)]
    for k in ("best_score", "best_bp", "best_anchor", "second_score"):
        np.testing.assert_array_equal(
            np.concatenate([h[k] for h in halves]), want["base"][k],
            err_msg=k)


# ---- paired end: rescue decides in a tandem repeat -------------------------

@pytest.fixture(scope="module")
def pe_setup():
    idx = build_index(tandem_genome_fasta(31))
    pairs = straddling_pairs(idx, 24, seed=32) + [
        (a.codes, b.codes) for a, b in simulate_pairs(
            idx.genome, 8, read_len=80, seed=5, min_insert=150,
            max_insert=260)]
    a1, l1 = prepare_batch([p[0] for p in pairs], 96, len(pairs))
    a2, l2 = prepare_batch([p[1] for p in pairs], 96, len(pairs))
    return idx, jupload(idx), (a1, l1, a2, l2)


def pe_cfg(indels):
    return AlignerConfig(max_errors=3, indels=indels, paired=True,
                         min_insert=120, max_insert=280, read_len_bucket=96,
                         batch_size=32)


@pytest.mark.parametrize("shard_index, indels",
                         [(0, True), (4, True), (4, False)])
def test_pe_mesh_matches_reference(pe_setup, shard_index, indels):
    """PE on 8 data slices, and on a 2 x 4 sharded mesh with the Myers scan
    rescue and with the Hamming one: every key (se1 / se2 nested) equals
    the JAX package's single-device map_batch_pe_device, and rescue decides
    most of the repeat pairs."""
    idx, jd, batch = pe_setup
    cfg = pe_cfg(indels)
    want = as_np(jpaired.map_batch_pe_device(
        jd, cfg, *(jnp.asarray(x) for x in batch)))
    m = make_cli_mappers(idx, cfg, mesh_devices(8), shard_index=shard_index)
    assert m.se is None and m.pe_dense is not None
    got = as_np(m.pe(*batch, int(batch[1].min()), int(batch[3].min())))
    assert_same(got, want)
    decided = got["resc_valid"].astype(bool) & ~got["pair_valid"].astype(bool)
    assert decided[:24].sum() >= 12


def test_pe_mapper_on_a_mesh(pe_setup):
    """make_sharded_pe_mapper's dense path on a 2 x 2 sharded mesh equals
    the single-device port's."""
    idx, _, batch = pe_setup
    cfg = pe_cfg(True).replace(compact=False)
    mesh = Mesh.grid(mesh_devices(4), 2, 2)
    got = make_sharded_pe_mapper(cfg, mesh, upload_mesh_index(idx, mesh))(
        *(torch.from_numpy(x) for x in batch))
    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device
    want = map_batch_pe_device(upload_index(idx), cfg,
                               *(torch.from_numpy(x) for x in batch))
    assert_same(as_np(got), as_np(want))


# ---- the sharded tables and fetches -----------------------------------------

def test_upload_index_sharded_matches_reference(setup):
    """The padded per-shard tables, put end to end, are the reference's
    global sharded arrays byte for byte; the strides are its padded ones
    and the whole tables sit on the group's first device."""
    idx = setup[0]
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "idx"))
    jd = jupload_sharded(idx, jmesh, "idx")
    td = upload_index_sharded(idx, mesh_devices(4))
    assert td.sharded and td.device == CPU
    for name in ("cp_rows", "sa_samples", "g_planes"):
        t = getattr(td, name)
        assert isinstance(t, Shards) and len(t.parts) == 4
        assert len({p.shape for p in t.parts}) == 1
        got = np.concatenate([p.numpy() for p in t.parts]).view(np.uint32)
        np.testing.assert_array_equal(got, np.asarray(getattr(jd, name)),
                                      err_msg=name)
    for name in ("cbase", "n", "klt"):
        np.testing.assert_array_equal(
            getattr(td, name).numpy().astype(np.int64) & 0xFFFFFFFF,
            np.asarray(getattr(jd, name)).astype(np.int64), err_msg=name)
    for name in ("rows_max", "samples_max", "genome_len", "g_words",
                 "sa_rate", "klt_k"):
        assert getattr(td, name) == getattr(jd, name), name
    assert td.nbytes >= upload_index(idx).nbytes


@pytest.mark.parametrize("W", [1, 2, 3, 17])
def test_gather_rows_shard_ref_matches_a_scalar_model(W):
    """Lanes on both sides of every shard boundary, before row 0 and in and
    past the last shard's padding: the row inside the range, zeros
    elsewhere; the shards' partial rows sum to the whole table's row."""
    rng = np.random.default_rng(W)
    rows, ns = 37, 4
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (rows * ns, W),
                                          dtype=np.int64).astype(np.int32))
    idx = torch.tensor([-5, -1, 0, 1] + [b + d for b in range(rows, rows * ns,
                                                             rows)
                                         for d in (-1, 0, 1)]
                       + [rows * ns - 1, rows * ns, rows * ns + 9],
                       dtype=torch.int64)
    total = torch.zeros((len(idx), W), dtype=torch.int32)
    for s in range(ns):
        part = table[s * rows:(s + 1) * rows].contiguous()
        got = kernels.gather_rows_shard_ref(part, idx, s * rows)
        for lane, i in enumerate(idx.tolist()):
            want = table[i] if s * rows <= i < (s + 1) * rows \
                else torch.zeros(W, dtype=torch.int32)
            assert torch.equal(got[lane], want), (s, i)
        total += got
        assert torch.equal(kernels.gather_rows_shard(part, idx, s * rows),
                           got)
    inside = (idx >= 0) & (idx < rows * ns)
    assert torch.equal(total[inside], table[idx[inside]])
    assert not total[~inside].any()
    shards = Shards(tuple(table[s * rows:(s + 1) * rows] for s in range(ns)))
    assert torch.equal(kernels.gather_table(shards, idx), total)


def test_sharded_fetches_match_replicated(setup):
    """fetch_cp_rows, fetch_sa_samples and window_planes on a 3-shard index
    equal the whole index's, at rows of both blocks, the last SA sample,
    window starts that wrap below 0 and windows over the last word."""
    idx = setup[0]
    whole, sharded = upload_index(idx), upload_index_sharded(idx,
                                                             mesh_devices(3))
    rng = np.random.default_rng(3)

    def both(fn):
        return fn(whole), fn(sharded)

    blk = torch.from_numpy(rng.integers(0, 2, 500))
    pos = torch.from_numpy(rng.integers(0, int(whole.n.min()), 500))
    pos[:3] = torch.tensor([0, int(whole.n[0]) - 1, int(whole.n[1]) - 1])
    a, b = both(lambda d: fm.fetch_cp_rows(
        d, pos // K.CP_BLOCK + blk * d.rows_max))
    assert torch.equal(a, b)
    a, b = both(lambda d: fm.fetch_sa_samples(
        d, blk * d.samples_max + pos // d.sa_rate))
    assert torch.equal(a, b)
    last = torch.tensor([whole.samples_max - 1, 2 * whole.samples_max - 1])
    assert torch.equal(fm.fetch_sa_samples(whole, last),
                       fm.fetch_sa_samples(
                           sharded, last + torch.tensor(
                               [0, sharded.samples_max - whole.samples_max])))
    L = whole.genome_len
    start = torch.from_numpy(rng.integers(0, L, 600))
    start[:4] = wrap(torch.tensor([-1, -3, -31, -32]))
    start[4:8] = torch.tensor([L - 1, L - 32, L - 33, L - 100])
    orient = torch.from_numpy(rng.integers(0, 2, 600))
    for nwords in (2, 3, 9):
        a, b = both(lambda d: verify.window_planes(
            d.g_planes, orient, start, nwords, L, d.g_words))
        for pa, pb in zip(a, b):
            assert torch.equal(pa, pb)


def test_kernels_refuse_a_sharded_table(setup):
    """gather_rows reads a whole table and refuses a shard set.  The fused
    wrappers take one: on CPU tensors their plain versions read it and
    equal the whole index's results; a set of more than MAX_SHARDS parts,
    or of parts of unequal shapes, is refused before any device is looked
    at."""
    idx = setup[0]
    whole = upload_index(idx)
    d = upload_index_sharded(idx, mesh_devices(3))
    rng = np.random.default_rng(5)
    lanes = torch.from_numpy(rng.integers(0, int(whole.n.min()), 64))
    blk = torch.from_numpy(rng.integers(0, 2, 64))
    pats = torch.from_numpy(rng.integers(1, 4, (64, 16)).astype(np.uint8))
    with pytest.raises(ValueError, match="shards"):
        kernels.gather_rows(d.cp_rows, lanes)
    calls = {
        "fm_locate": lambda x: kernels.fm_locate(x, blk, lanes, lanes > 9),
        "fm_search": lambda x: kernels.fm_search(
            x, blk, pats, lanes % 4, lanes % 4 + 12, None, None, 0, 16),
        "fm_extend": lambda x: kernels.fm_extend(
            x, blk, pats, lanes % 16, lanes,
            (lanes + 900).clamp(max=int(whole.n.min())), 6, 2),
        "verify_fused_gather": lambda x: kernels.verify_fused_gather(
            x.g_planes, blk, wrap(lanes - 3), torch.zeros((1, 6),
                                                          dtype=torch.int64),
            lanes * 0, lanes % 64, x.genome_len, x.g_words, 64, 70, 3),
        "rescue_scan": lambda x: kernels.rescue_scan(
            x.g_planes, blk, wrap(lanes - 3), lanes > 5, lanes,
            lanes % 200, lanes * 0 + 60, torch.zeros((64, 4, 2),
                                                     dtype=torch.int64),
            torch.zeros((64, 2), dtype=torch.int64), x.genome_len,
            x.g_words, 64, 3, 200),
    }
    for name, call in calls.items():
        got, want = call(d), call(whole)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name
    nine = upload_index_sharded(idx, mesh_devices(9))
    cut = Shards(d.g_planes.parts[:2] + (d.g_planes.parts[2][:-1],))
    for name, call in calls.items():
        with pytest.raises(ValueError, match="shards"):
            call(nine)
        bad = dataclasses.replace(d, g_planes=cut) \
            if name in ("verify_fused_gather", "rescue_scan") \
            else dataclasses.replace(d, cp_rows=Shards(
                d.cp_rows.parts[:2] + (d.cp_rows.parts[2][:-1],)))
        with pytest.raises(ValueError, match="shards"):
            call(bad)


def test_sharded_paths_launch_the_fused_kernels(setup, pe_setup, monkeypatch):
    """On a sharded index the mapping paths call what one card calls:
    map_batch_device and map_batch_pe_device (with rescue by the Myers
    scan) reach kernels.fm_search / fm_extend / fm_locate /
    verify_fused_gather / rescue_scan, and no lockstep loop but as the
    fused wrappers' plain versions (one call each per wrapper call)."""
    from bitmapperbs_tpu_torch.models.aligner import map_batch_device
    from bitmapperbs_tpu_torch.models.paired import map_batch_pe_device

    names = ("fm_search", "fm_extend", "fm_locate", "verify_fused_gather",
             "rescue_scan", "search_lockstep", "extend_lockstep",
             "locate_lockstep")
    calls = dict.fromkeys(names, 0)

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, call)

    for name in names:
        spy(fm if name.endswith("lockstep") else kernels, name)
    idx, reads, lengths, want = setup
    d = upload_index_sharded(idx, mesh_devices(2))
    got = map_batch_device(d, EXT, torch.from_numpy(reads),
                           torch.from_numpy(lengths))
    assert_same(as_np(got), want["ext"])
    pidx, jd, batch = pe_setup
    cfg = pe_cfg(True)
    got = map_batch_pe_device(upload_index_sharded(pidx, mesh_devices(2)),
                              cfg, *(torch.from_numpy(x) for x in batch))
    assert_same(as_np(got), as_np(jpaired.map_batch_pe_device(
        jd, cfg, *(jnp.asarray(x) for x in batch))))
    for name in ("fm_search", "fm_extend", "fm_locate",
                 "verify_fused_gather", "rescue_scan"):
        assert calls[name] > 0, (name, calls)
    for k in ("search", "extend", "locate"):
        assert calls[f"{k}_lockstep"] == calls[f"fm_{k}"], calls


def test_peer_access_at_placement(setup, monkeypatch):
    """A sharded index whose cards lack peer access is refused where it is
    placed, with both cards named; where they have it, peer access is
    enabled once per (lanes' card, other shard card) pair, and not for a
    card that appears twice or for the CPU."""
    idx = setup[0]
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    with pytest.raises(ValueError, match="cuda:0.*cuda:1"):
        upload_index_sharded(idx, cards)
    with pytest.raises(ValueError, match="cuda:0.*cuda:1"):
        upload_mesh_index(idx, Mesh.grid(cards, 1, 2))
    d = upload_index_sharded(idx, mesh_devices(2))
    with pytest.raises(ValueError, match="cuda:0.*cuda:1"):
        from bitmapperbs_tpu_torch.parallel import shard
        shard._place(d, cards)
    enabled = []
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    monkeypatch.setattr(kernels, "_lib", lambda: types.SimpleNamespace(
        btbs_enable_peer_access=lambda a, b: enabled.append((a, b)) or 0))
    kernels.enable_peer_access(cards[0], [cards[0], cards[1], cards[1],
                                          torch.device("cuda", 2)])
    assert enabled == [(0, 1), (0, 1), (0, 2)]
    kernels.enable_peer_access(CPU, [CPU] * 3)
    kernels.enable_peer_access(cards[1], [cards[1]])
    assert len(enabled) == 3


def test_mesh_and_batch_split():
    """Mesh.grid lays devices out row by row; shard_batch gives equal row
    slices on each group's first device, and refuses a batch that does not
    split; a ragged device count does not divide into --shard-index."""
    devs = mesh_devices(8)
    assert Mesh.grid(devs, 1).shape == {"data": 1}
    m = Mesh.grid(devs, 2, 4)
    assert m.shape == {"data": 2, "idx": 4}
    assert [len(r) for r in m.devices] == [4, 4]
    reads = np.arange(24, dtype=np.uint8).reshape(6, 4)
    parts = shard_batch(Mesh.grid(devs[:3], 3), reads, np.arange(6))
    assert [p[0].tolist() for p in parts] == [reads[i:i + 2].tolist()
                                              for i in (0, 2, 4)]
    assert [p[1].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh.grid(devs, 4), reads, np.arange(6))
    with pytest.raises(ValueError, match="need 16 devices"):
        Mesh.grid(devs, 4, 4)
    with pytest.raises(ValueError, match="does not divide device count 6"):
        make_cli_mappers(None, CFG, devs[:6], shard_index=4)
