"""The shard mesh of the port (pilosa_tpu_torch/parallel/mesh.py and the
meshed exec/cuda.py CUDABackend), run on the CPU with the kernels' plain
versions, against the JAX package's meshed TPUBackend on the 8-device
virtual CPU platform tests/conftest.py forces.

One data directory (tests/test_mesh.py's data: 11 shards, fields f, g, hh
and the BSI field v) is written by the JAX package and copied. The JAX
TPUBackend(mesh=ShardMesh(jax.devices()[:n])) serves one copy;
CUDABackend(device="cpu", mesh=ShardMesh(["cpu"] * n)) and the unmeshed
CUDABackend(device="cpu") serve the other, for n = 8 and 3 (11 shards pad
to 16 and 12). Every family of tests/test_mesh.py must answer alike on
all three across write epochs, with the resident stacks spliced, not
rebuilt. Also: the ShardMesh contract, K15's plain form against the JAX
package's splice_shard_slabs byte for byte, the sharded stream build, and
the two places where a mesh changes routing (K5's shard bound a part,
row_batch_async's slab budget a device) against the JAX backend's
launches.
"""

import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.core.field import options_for_int  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec import tpu as jax_tpu  # noqa: E402
from pilosa_tpu.exec.batcher import ShardLegBatcher as JaxBatcher  # noqa: E402
from pilosa_tpu.exec.result import result_to_json as jax_json  # noqa: E402
from pilosa_tpu.exec.tpu import TPUBackend  # noqa: E402
from pilosa_tpu.ops.kernels import splice_shard_slabs  # noqa: E402
from pilosa_tpu.parallel import ShardMesh as JaxShardMesh  # noqa: E402
from pilosa_tpu.pql import parse_string as jax_parse  # noqa: E402
from pilosa_tpu.utils.stats import global_stats as jax_stats  # noqa: E402
from pilosa_tpu_torch.carry import open_reference_holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec import cuda as cuda_mod  # noqa: E402
from pilosa_tpu_torch.exec.batcher import ShardLegBatcher  # noqa: E402
from pilosa_tpu_torch.exec.cuda import CUDABackend  # noqa: E402
from pilosa_tpu_torch.exec.result import result_to_json  # noqa: E402
from pilosa_tpu_torch.ops import kernels as K  # noqa: E402
from pilosa_tpu_torch.ops import sparse  # noqa: E402
from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD, pack_fragment  # noqa: E402
from pilosa_tpu_torch.parallel import (  # noqa: E402
    MeshConfigError,
    ShardMesh,
    Sharded,
    pad_to_multiple,
)
from pilosa_tpu_torch.pql import parse_string  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.utils.stats import global_stats  # noqa: E402
from tests.test_mesh import FAMILIES, N_SHARDS  # noqa: E402

STACK_COUNTERS = ("stack_incremental_updates_total", "stack_incremental_shards_total",
                  "stack_full_rebuilds_total")

#: Write epochs, each through both packages' executors: bit writes on
#: resident rows (a Set, then a Clear of another bit) and BSI value writes.
EPOCHS = [
    ["Set(5, f=1)", f"Set({3 * SHARD_WIDTH + 17}, g=7)", "Set(29, v=333)"],
    [f"Clear({7 * SHARD_WIDTH + 2}, f=2)", f"Set({10 * SHARD_WIDTH + 9}, g=7)",
     "Set(126, v=-332)"],
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path):
    """tests/test_mesh.py's _setup, written by the JAX package."""
    h = JaxHolder(path).open()
    rng = np.random.default_rng(13)
    idx = h.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("hh")
    idx.create_field("v", options_for_int(-500, 500))
    span = N_SHARDS * SHARD_WIDTH
    for row in (1, 2, 3):
        cols = np.unique(rng.integers(0, span, 6000, dtype=np.uint64))
        idx.field("f").import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
        idx.existence_field().import_bits(np.zeros(cols.size, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, span, 4000, dtype=np.uint64))
    idx.field("g").import_bits(np.full(cols.size, 7, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, span, 1500, dtype=np.uint64))
    idx.field("hh").import_bits(rng.integers(0, 2, cols.size, dtype=np.uint64), cols)
    cols = np.unique(rng.integers(0, span, 900, dtype=np.uint64))
    idx.field("v").import_value(cols, rng.integers(-500, 501, cols.size))
    h.close()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("jax_mesh_written"))
    _write(src)
    return src


class _Meshes:
    """The JAX meshed backend on one copy of the data, the port's meshed and
    unmeshed backends on the other, each executor with its batcher."""

    def __init__(self, src, root, n, max_bytes=None):
        jdir, tdir = str(root / "jax"), str(root / "port")
        shutil.copytree(src, jdir)
        shutil.copytree(src, tdir)
        self.n = n
        self.jh = JaxHolder(jdir).open()
        self.th = open_reference_holder(tdir)
        self.jbe = TPUBackend(self.jh, mesh=JaxShardMesh(jax.devices()[:n]), max_bytes=max_bytes)
        self.mbe = CUDABackend(self.th, device="cpu", mesh=ShardMesh(["cpu"] * n),
                               max_bytes=max_bytes)
        self.obe = CUDABackend(self.th, device="cpu", max_bytes=max_bytes)
        self.jax = JaxExecutor(self.jh, backend=self.jbe)
        self.jax.batcher = JaxBatcher(self.jbe)
        self.mesh = Executor(self.th, backend=self.mbe)
        self.mesh.batcher = ShardLegBatcher(self.mbe)
        self.one = Executor(self.th, backend=self.obe)
        self.one.batcher = ShardLegBatcher(self.obe)

    def close(self):
        self.jh.close()
        self.th.close()

    def write(self, q):
        assert self.jax.execute("i", q) == self.mesh.execute("i", q), q

    def answers(self, ex, to_json, queries=FAMILIES):
        return {q: [to_json(r) for r in ex.execute("i", q)] for q in queries}

    def same(self, what, queries=FAMILIES):
        want = self.answers(self.jax, jax_json, queries)
        got = self.answers(self.mesh, result_to_json, queries)
        for q in queries:
            assert got[q] == want[q], (what, q)
        one = self.answers(self.one, result_to_json, queries)
        for q in queries:
            assert one[q] == want[q], (what, "unmeshed", q)


def _counters(stats, names=STACK_COUNTERS):
    return {n: sum(stats.counter_totals(n).values()) for n in names}


def _kinds(stats) -> dict:
    """device_launches_total by kind."""
    out = {}
    for series, v in stats.counter_totals("device_launches_total").items():
        kind = series.split('kind="')[1].split('"')[0]
        out[kind] = out.get(kind, 0) + v
    return out


@pytest.fixture(params=[8, 3], ids=["n8", "n3"])
def meshes(request, written, tmp_path):
    m = _Meshes(written, tmp_path, request.param)
    yield m
    m.close()


# ---------------------------------------------------------------------------
# the backend against the JAX meshed backend
# ---------------------------------------------------------------------------


def test_families_equal_across_churn_epochs(meshes):
    """Every family answers alike on the JAX meshed backend and the port's
    meshed and unmeshed ones, cold and after each write epoch; the port's
    epochs are absorbed by splices of the resident sharded stacks, no stack
    rebuilt whole, as the JAX backend's are."""
    meshes.same("cold")
    stacks = meshes.mbe.blocks._entries
    assert stacks and all(isinstance(e[1], Sharded) for e in stacks.values())
    assert all(e[1].shape[0] == pad_to_multiple(N_SHARDS, meshes.n) for e in stacks.values())
    routed = sum(global_stats.counter_totals("cpu_routed_total").values())
    jax0, port0 = _counters(jax_stats), _counters(global_stats)
    k15 = K.launch_counts().get("splice_slabs", 0)
    for k, writes in enumerate(EPOCHS):
        for q in writes:
            meshes.write(q)
        meshes.same(f"epoch {k}")
    jax1, port1 = _counters(jax_stats), _counters(global_stats)
    # The port's meshed and unmeshed backends both splice: the JAX side has
    # one backend, so the port's deltas are twice its own, split evenly.
    assert port1["stack_full_rebuilds_total"] == port0["stack_full_rebuilds_total"]
    assert jax1["stack_full_rebuilds_total"] == jax0["stack_full_rebuilds_total"]
    for name in ("stack_incremental_updates_total", "stack_incremental_shards_total"):
        assert jax1[name] > jax0[name]
        assert port1[name] - port0[name] == 2 * (jax1[name] - jax0[name]), name
    # On the CPU the wrapper takes the plain form: no launch is counted.
    assert K.launch_counts().get("splice_slabs", 0) == k15
    assert sum(global_stats.counter_totals("cpu_routed_total").values()) == routed


def test_one_dirty_shard_ships_one_slab(meshes):
    """A write to one shard splices one slab into its part (one K15 call),
    never the part or the stack; the JAX program ships a slab for every
    device's lane."""
    q = "Row(f=1)"
    meshes.same("cold", [q])
    fobj = meshes.th.index("i").field("f")
    block, rows_p = meshes.mbe.blocks.get("i", fobj, tuple(range(N_SHARDS)))
    calls = []
    real = cuda_mod.splice_slabs
    cuda_mod.splice_slabs = lambda *a: (calls.append(a), real(*a))
    try:
        before = _counters(global_stats, STACK_COUNTERS + ("stack_update_bytes_total",))
        jbefore = _counters(jax_stats, ("stack_update_bytes_total",))
        meshes.write(f"Set({4 * SHARD_WIDTH + 3}, f=1)")
        meshes.same("one write", [q])
        after = _counters(global_stats, STACK_COUNTERS + ("stack_update_bytes_total",))
    finally:
        cuda_mod.splice_slabs = real
    slab = rows_p * WORDS_PER_SHARD * 4
    # The meshed backend's splice, and the unmeshed one's index_copy_.
    assert after["stack_incremental_shards_total"] - before["stack_incremental_shards_total"] == 2
    assert after["stack_full_rebuilds_total"] == before["stack_full_rebuilds_total"]
    assert after["stack_update_bytes_total"] - before["stack_update_bytes_total"] == 2 * slab
    jshipped = _counters(jax_stats, ("stack_update_bytes_total",))["stack_update_bytes_total"]
    assert jshipped - jbefore["stack_update_bytes_total"] == meshes.n * slab
    assert len(calls) == 1
    part, slabs, idx, valid = calls[0]
    s_local = block.parts[0].shape[0]
    assert part is block.parts[4 // s_local]
    assert idx.tolist() == [4 % s_local] and valid.tolist() == [1]
    assert tuple(slabs.shape) == (1, rows_p, WORDS_PER_SHARD)


def test_meshed_stacks_equal_fresh_packs(meshes):
    """After the epochs, each part of every resident stack holds exactly
    its shards' fresh packs and zero padding."""
    ex = meshes.mesh
    reads = [q for q in FAMILIES if not q.startswith("GroupBy")]
    for q in reads:
        ex.execute("i", q)
    for writes in EPOCHS:
        for q in writes:
            ex.execute("i", q)
    for q in reads:
        ex.execute("i", q)
    idx = meshes.th.index("i")
    for key, ent in meshes.mbe.blocks._entries.items():
        if len(key) > 3:
            continue
        arr, rows_p = ent[1], ent[2]
        view = idx.field(key[1]).view(key[2])
        want = np.zeros((arr.shape[0], rows_p, WORDS_PER_SHARD), dtype=np.uint32)
        for i, s in enumerate(range(N_SHARDS)):
            fr = view.fragment(s) if view is not None else None
            if fr is not None:
                want[i] = pack_fragment(fr, n_rows=rows_p)
        got = torch.cat([p for p in arr.parts]).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=str(key))


def test_sharded_stream_build_equals_dense(written, tmp_path, monkeypatch):
    """With the chunk shrunk so the stacks stream (ops/sparse.py), the
    meshed backend builds one ChunkedStackBuilder a part and its stacks
    equal the dense packs, padding zero; its answers equal the JAX
    meshed backend's."""
    monkeypatch.setattr(sparse, "CHUNK_WORDS", 1 << 12)
    monkeypatch.setattr(sparse, "MIN_CHUNKED_WORDS", 1 << 13)
    m = _Meshes(written, tmp_path, 3)
    try:
        built = []
        real = sparse.ChunkedStackBuilder

        class Spy(real):
            def __init__(self, device, shape, timed=False):
                built.append(tuple(shape))
                super().__init__(device, shape, timed)

        monkeypatch.setattr(sparse, "ChunkedStackBuilder", Spy)
        m.same("streamed", FAMILIES[:10])
        assert built and all(s[0] == pad_to_multiple(N_SHARDS, 3) // 3 for s in built
                             if len(s) == 3 and s[0] != N_SHARDS)
        fobj = m.th.index("i").field("f")
        block, rows_p = m.mbe.blocks.get("i", fobj, tuple(range(N_SHARDS)))
        want = np.zeros((12, rows_p, WORDS_PER_SHARD), dtype=np.uint32)
        for s in range(N_SHARDS):
            want[s] = pack_fragment(fobj.view("standard").fragment(s), n_rows=rows_p)
        np.testing.assert_array_equal(torch.cat(block.parts).numpy().view(np.uint32), want)
    finally:
        m.close()


@pytest.mark.parametrize("n", [8, 3])
def test_meshed_row_paging_equals_jax(written, tmp_path, n):
    """Under a byte budget that holds two padded row pages but no stack,
    every family answers on the port's meshed backend as on the JAX meshed
    backend under the same budget: Counts and bitmap reads over padded row
    pages (get_row), TopN over padded, psum'd pages
    (_topn_paged_counts), the rest routed as the reference routes them.
    Each query's page uploads and page bytes (the padding included, as the
    JAX package counts them) equal the reference's, and so do the resident
    bytes after it."""
    counters = ("hbm_page_uploads_total", "hbm_page_bytes_total")
    page = pad_to_multiple(N_SHARDS, n) * WORDS_PER_SHARD * 4
    m = _Meshes(written, tmp_path, n, max_bytes=2 * page + page // 2)
    uploads = {}
    try:
        for q in FAMILIES:
            j0, t0 = _counters(jax_stats, counters), _counters(global_stats, counters)
            want = [jax_json(r) for r in m.jax.execute("i", q)]
            got = [result_to_json(r) for r in m.mesh.execute("i", q)]
            jd = {c: v - j0[c] for c, v in _counters(jax_stats, counters).items()}
            td = {c: v - t0[c] for c, v in _counters(global_stats, counters).items()}
            assert got == want, q
            assert td == jd, q
            assert m.mbe.blocks.resident_bytes() == m.jbe.blocks.resident_bytes(), q
            assert all(isinstance(e[1], Sharded) for e in m.mbe.blocks._entries.values()), q
            uploads[q] = td["hbm_page_uploads_total"]
        assert uploads["Count(Intersect(Row(f=1), Row(g=7)))"] > 0
        assert uploads["Row(f=2)"] > 0 and uploads["TopN(f, n=3)"] > 0
    finally:
        m.close()


def test_batched_paths_match_singles(meshes):
    """The batcher's group launches through the port's meshed backend agree
    with per-query execution (tests/test_mesh.py's batched check)."""
    be = meshes.mbe
    batcher = ShardLegBatcher(be)
    shards = list(range(N_SHARDS))
    calls = [parse_string(f"Intersect(Row(f={r}), Row(g=7))").calls[0] for r in (1, 2, 3)]
    singles = [be.count_shards("i", c, shards) for c in calls]
    assert batcher.count("i", calls, shards) == singles
    row_call = parse_string("Intersect(Row(f=1), Row(g=7))").calls[0]
    assert (batcher.row("i", row_call, shards).columns().tolist()
            == be.bitmap_call("i", row_call, shards).columns().tolist())
    assert batcher.topn("i", "f", shards, 3) == be.topn_field("i", "f", shards, 3)
    assert batcher.bsi("bsi_sum", "i", "v", shards) == be.bsi_sum("i", "v", shards)
    # A shard subset and single shards read the resident parts.
    sub = [1, 4, 9]
    assert be.count_shards("i", calls[0], sub) == sum(be.count_shard("i", calls[0], s)
                                                      for s in sub)
    assert (be.bitmap_call("i", row_call, sub).columns().tolist()
            == meshes.obe.bitmap_call("i", row_call, sub).columns().tolist())


def test_explain_records_name_the_mesh(meshes):
    """An EXPLAIN launch record carries the mesh's part count, and the
    executor's device placement names the mesh, as the JAX package's do;
    one record a meshed program, as device_launches_total counts."""
    from pilosa_tpu_torch.utils.qprofile import ExplainPlan, profile_scope

    assert meshes.mesh._explain_devices() == {"n": meshes.n, "mesh": True,
                                              "backend": "CUDABackend"}
    assert meshes.jax._explain_devices()["n"] == meshes.n
    assert meshes.one._explain_devices()["n"] == 1
    for q in ("Count(Intersect(Row(f=1), Row(g=7)))", "TopN(f, n=2)", "Sum(field=v)",
              "GroupBy(Rows(f), Rows(g), Rows(hh))"):
        before = _kinds(global_stats)
        with profile_scope(index="i", query=q) as prof:
            prof.explain = ExplainPlan()
            meshes.mesh.execute("i", q)
        launched = sum(_kinds(global_stats).values()) - sum(before.values())
        records = [r for c in prof.explain.calls for r in c.get("launches", [])]
        assert launched >= 1 and len(records) == launched, q
        assert all(r["devices"] == meshes.n and r["bytesShipped"] > 0 for r in records), q


# ---------------------------------------------------------------------------
# where a mesh changes routing, against the JAX backend's launches
# ---------------------------------------------------------------------------


def test_group_tile_shard_bound_is_per_part(meshes, monkeypatch):
    """K5's int32 accumulators bound the shards one launch sweeps: under a
    mesh a part's (the JAX package's s_kernel). With the bound between a
    part's shards and the padded axis, the meshed 3-field GroupBy still runs
    the per-shard tiles (group_tile_pershard) as the JAX meshed backend
    does, where an unmeshed backend routes it to the host."""
    s_pad = pad_to_multiple(N_SHARDS, meshes.n)
    bound = s_pad // meshes.n
    monkeypatch.setattr(jax_tpu, "MAX_PAIR_SHARDS", bound)
    monkeypatch.setattr(cuda_mod, "MAX_PAIR_SHARDS", bound)
    q = "GroupBy(Rows(f), Rows(g), Rows(hh))"
    jb, tb = _kinds(jax_stats), _kinds(global_stats)
    want = [jax_json(r) for r in meshes.jax.execute("i", q)]
    assert [result_to_json(r) for r in meshes.mesh.execute("i", q)] == want
    jd = {k: v - jb.get(k, 0) for k, v in _kinds(jax_stats).items() if v != jb.get(k, 0)}
    td = {k: v - tb.get(k, 0) for k, v in _kinds(global_stats).items() if v != tb.get(k, 0)}
    assert jd.get("group_tile_pershard", 0) >= 1
    assert td.get("group_tile_pershard") == jd["group_tile_pershard"]
    routed = sum(global_stats.counter_totals("cpu_routed_total").values())
    assert [result_to_json(r) for r in meshes.one.execute("i", q)] == want
    assert sum(global_stats.counter_totals("cpu_routed_total").values()) == routed + 1


def test_row_batch_budget_is_per_device(meshes, monkeypatch):
    """row_batch_async's output budget is a device's: under a mesh each
    part holds s_pad / n shards of a slot's slab, so a launch takes n times
    more slots than the whole axis would allow; the launches per window
    equal the JAX meshed backend's. Each launch's output stays in its
    parts, read back one by one: no tensor read back, and so none held on a
    device, is larger than the budget."""
    s_local = pad_to_multiple(N_SHARDS, meshes.n) // meshes.n
    budget = 4 * s_local * WORDS_PER_SHARD * 4
    monkeypatch.setattr(jax_tpu, "MAX_ROW_BATCH_BYTES", budget)
    monkeypatch.setattr(cuda_mod, "MAX_ROW_BATCH_BYTES", budget)
    shards = list(range(N_SHARDS))
    pql = [f"Union(Row(f={1 + k % 3}), Row(g={7 + k // 3}))" for k in range(8)]
    jcalls = [jax_parse(q).calls[0] for q in pql]
    tcalls = [parse_string(q).calls[0] for q in pql]
    read_back = []
    real = meshes.mbe._to_host_words
    monkeypatch.setattr(meshes.mbe, "_to_host_words",
                        lambda t: (read_back.append(t.nbytes), real(t))[1])
    jb, tb = _kinds(jax_stats), _kinds(global_stats)
    want = [r.columns().tolist() for r in meshes.jbe.row_batch_async("i", jcalls, shards)()]
    got = [r.columns().tolist() for r in meshes.mbe.row_batch_async("i", tcalls, shards)()]
    assert got == want
    jd = sum(_kinds(jax_stats).get(k, 0) - jb.get(k, 0) for k in ("vec", "vec_batch"))
    td = _kinds(global_stats).get("vec_batch", 0) - tb.get("vec_batch", 0)
    assert td == jd == 2  # 8 distinct slots, 4 a launch
    assert len(read_back) == 2 * meshes.n and max(read_back) <= budget
    sub = [9, 1, 4, 1]
    want_sub = [r.columns().tolist() for r in meshes.jbe.row_batch_async("i", jcalls, sub)()]
    assert [r.columns().tolist()
            for r in meshes.mbe.row_batch_async("i", tcalls, sub)()] == want_sub
    one = [r.columns().tolist() for r in meshes.obe.row_batch_async("i", tcalls, shards)()]
    assert one == want
    assert _kinds(global_stats).get("vec_batch", 0) - tb.get("vec_batch", 0) - td > 2


# ---------------------------------------------------------------------------
# K15's plain form against the JAX package's splice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entries", [
    [(0, 1)],
    [(2, 1), (2, 1)],                 # a duplicate: the later slab wins
    [(1, 0), (3, 1)],                 # an invalid entry leaves its shard
    [(-4, 1), (9, 1)],                # clipped to the first and the last
    [(3, 1), (0, 0), (3, 1), (1, 1)],  # duplicate and invalid mixed
    [(0, 0), (0, 0)],                 # nothing valid
], ids=["one", "duplicate", "invalid", "clipped", "mixed", "none-valid"])
def test_splice_plain_form_equals_jax_splice_byte_for_byte(entries):
    rng = np.random.default_rng(len(entries) * 7 + entries[0][0] + 11)
    s_local, rows, w = 4, 3, 64
    block = rng.integers(0, 2**32, (s_local, rows, w), dtype=np.uint32)
    slabs = rng.integers(0, 2**32, (len(entries), rows, w), dtype=np.uint32)
    idx = np.array([e[0] for e in entries], dtype=np.int32)
    valid = np.array([e[1] for e in entries], dtype=np.uint32)
    want = np.asarray(splice_shard_slabs(block, slabs, idx, valid))
    got = torch.from_numpy(block.copy().view(np.int32))
    K.splice_slabs(got, torch.from_numpy(slabs.view(np.int32)), idx, valid)
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()


def test_splice_refuses_what_the_kernel_cannot_take():
    block = torch.zeros((2, 1, 8), dtype=torch.int32)
    slabs = torch.zeros((1, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="indices"):
        K.splice_slabs(block, slabs, [0, 1], [1])
    with pytest.raises(ValueError, match="fit"):
        K.splice_slabs(block, torch.zeros((1, 2, 8), dtype=torch.int32), [0], [1])
    many = K.MAX_SPLICE_ENTRIES + 1
    with pytest.raises(ValueError, match="exceed"):
        K.splice_slabs(block, torch.zeros((many, 1, 8), dtype=torch.int32),
                       [0] * many, [1] * many)


# ---------------------------------------------------------------------------
# the ShardMesh contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 3])
def test_put_pads_to_device_multiple(n):
    mesh = ShardMesh(["cpu"] * n)
    arr = np.arange(N_SHARDS * 4, dtype=np.uint32).reshape(N_SHARDS, 4)
    placed = mesh.put(arr)
    assert isinstance(placed, Sharded) and len(placed.parts) == n
    assert placed.shape[0] == pad_to_multiple(N_SHARDS, n) and placed.real == N_SHARDS
    assert {tuple(p.shape) for p in placed.parts} == {(placed.shape[0] // n, 4)}
    host = torch.cat(placed.parts).numpy().view(np.uint32)
    np.testing.assert_array_equal(host[:N_SHARDS], arr)
    assert not host[N_SHARDS:].any()  # zero slabs: inert in every reduction
    np.testing.assert_array_equal(placed.gather().numpy().view(np.uint32), arr)
    assert placed.nbytes == sum(placed.part_bytes()) == placed.numel() * 4


def test_put_exact_multiple_unpadded():
    mesh = ShardMesh(["cpu"] * 4)
    arr = np.ones((8, 3), dtype=np.uint32)
    placed = mesh.put(arr)
    assert tuple(placed.shape) == arr.shape and placed.real == 8
    assert placed.narrow(0, 5, 1).tolist() == [[1, 1, 1]]
    with pytest.raises(ValueError, match="cross a part"):
        placed.narrow(0, 1, 2)


def test_empty_device_list_is_structured_error():
    with pytest.raises(MeshConfigError):
        ShardMesh(devices=[])
    assert issubclass(MeshConfigError, ValueError)
    with pytest.raises(MeshConfigError, match="mix"):
        ShardMesh(["cpu", "meta"])


def test_pad_to_multiple_matches_jax():
    from pilosa_tpu.parallel import pad_to_multiple as jax_pad

    for n, m in [(11, 8), (16, 8), (1, 8), (5, 1), (0, 8), (954, 4), (954, 2)]:
        assert pad_to_multiple(n, m) == jax_pad(n, m)


def test_backend_mesh_of_one_is_none_and_types_must_match():
    from pilosa_tpu_torch.core import Holder

    h = Holder(None).open()
    try:
        assert CUDABackend(h, device="cpu", mesh=ShardMesh(["cpu"])).mesh is None
        with pytest.raises(ValueError, match="device='cpu'"):
            CUDABackend(h, device="meta", mesh=ShardMesh(["cpu"] * 2))
    finally:
        h.close()
