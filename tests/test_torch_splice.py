"""The dirty-shard splice of the port (exec/cuda.py _StackedBlocks._splice,
ops/kernels.py splice_pairs and splice_slabs, ops/csrc/splice.cu K15), run
on the CPU with the kernels' plain versions, against the JAX package.

A part takes its dirty shards in rounds of at most MAX_SPLICE_ENTRIES slabs
and sparse.CHUNK_WORDS words, one K15 call a round under a mesh; the rounds
stage through ops/sparse.py's buffer pool. K15's host resolver and plain
form are held against the JAX package's splice_shard_slabs byte for byte
with duplicate, invalid and clipped entries, and the spliced stacks answer
as the JAX package's meshed TPUBackend does.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pilosa_tpu.core import Holder as JaxHolder  # noqa: E402
from pilosa_tpu.exec import Executor as JaxExecutor  # noqa: E402
from pilosa_tpu.exec.result import result_to_json as jax_json  # noqa: E402
from pilosa_tpu.exec.tpu import TPUBackend  # noqa: E402
from pilosa_tpu.ops.kernels import splice_shard_slabs  # noqa: E402
from pilosa_tpu.parallel import ShardMesh as JaxShardMesh  # noqa: E402
from pilosa_tpu_torch.carry import open_reference_holder  # noqa: E402
from pilosa_tpu_torch.exec import Executor  # noqa: E402
from pilosa_tpu_torch.exec import cuda as cuda_mod  # noqa: E402
from pilosa_tpu_torch.exec.cuda import CUDABackend  # noqa: E402
from pilosa_tpu_torch.exec.result import result_to_json  # noqa: E402
from pilosa_tpu_torch.ops import kernels as K  # noqa: E402
from pilosa_tpu_torch.ops import sparse  # noqa: E402
from pilosa_tpu_torch.ops.blocks import WORDS_PER_SHARD, pack_fragment  # noqa: E402
from pilosa_tpu_torch.parallel import ShardMesh  # noqa: E402
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH  # noqa: E402
from pilosa_tpu_torch.utils.stats import global_stats  # noqa: E402

#: Shards of the index: two parts of 40 under a mesh of 2.
N_SHARDS = 80
PARTS = 2
QUERIES = ["Count(Row(f=1))", "Row(f=2)", "Count(Union(Row(f=1), Row(f=3)))",
           "TopN(f, n=2)"]
COUNTERS = ("stack_incremental_updates_total", "stack_incremental_shards_total",
            "stack_full_rebuilds_total", "stack_update_bytes_total")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain kernels' tensors here are small, and
    test files run side by side. Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """f's rows 1 to 3 over N_SHARDS shards, a few bits a shard, written by
    the JAX package."""
    path = str(tmp_path_factory.mktemp("jax_splice_written"))
    h = JaxHolder(path).open()
    rng = np.random.default_rng(21)
    idx = h.create_index("i")
    idx.create_field("f")
    for row in (1, 2, 3):
        cols = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 400, dtype=np.uint64))
        idx.field("f").import_bits(np.full(cols.size, row, dtype=np.uint64), cols)
    h.close()
    return path


class _Pair:
    """The JAX meshed backend on one copy of the data; the port's meshed
    and unmeshed backends on the other."""

    def __init__(self, src, root):
        jdir, tdir = str(root / "jax"), str(root / "port")
        shutil.copytree(src, jdir)
        shutil.copytree(src, tdir)
        self.jh = JaxHolder(jdir).open()
        self.th = open_reference_holder(tdir)
        self.jax = JaxExecutor(self.jh, backend=TPUBackend(
            self.jh, mesh=JaxShardMesh(jax.devices()[:PARTS])))
        self.mbe = CUDABackend(self.th, device="cpu", mesh=ShardMesh(["cpu"] * PARTS))
        self.mesh = Executor(self.th, backend=self.mbe)
        self.obe = CUDABackend(self.th, device="cpu")
        self.one = Executor(self.th, backend=self.obe)

    def write(self, q):
        assert self.jax.execute("i", q) == self.mesh.execute("i", q), q

    def same(self, what):
        for q in QUERIES:
            want = [jax_json(r) for r in self.jax.execute("i", q)]
            assert [result_to_json(r) for r in self.mesh.execute("i", q)] == want, (what, q)
            assert [result_to_json(r) for r in self.one.execute("i", q)] == want, (what, q)

    def stacks_equal_fresh_packs(self):
        """Both backends' f stacks equal fresh packs of every shard."""
        frags = self.th.index("i").field("f").view("standard")
        for be in (self.mbe, self.obe):
            block, rows_p = be.blocks.get("i", self.th.index("i").field("f"),
                                          tuple(range(N_SHARDS)))
            got = torch.cat(list(block.parts)) if be is self.mbe else block
            for s in range(N_SHARDS):
                fr = frags.fragment(s)
                want = (pack_fragment(fr, n_rows=rows_p) if fr is not None else
                        np.zeros((rows_p, WORDS_PER_SHARD), dtype=np.uint32))
                assert got[s].numpy().view(np.uint32).tobytes() == want.tobytes(), s

    def close(self):
        self.jh.close()
        self.th.close()


@pytest.fixture
def pair(written, tmp_path):
    p = _Pair(written, tmp_path)
    yield p
    p.close()


def _counters():
    return {n: sum(global_stats.counter_totals(n).values()) for n in COUNTERS}


def _k15_calls():
    """Records every K15 call the meshed backend's splice makes."""
    calls = []
    real = cuda_mod.splice_slabs
    cuda_mod.splice_slabs = lambda *a: (calls.append(a), real(*a))
    return calls, real


def test_a_round_carries_up_to_32_slabs_a_part(pair):
    """40 dirty shards of one part are spliced in ceil(40 / 32) = 2 K15
    calls, 32 slabs then 8; one dirty shard in 1 call of one slab. Every
    answer equals the JAX meshed backend's, no stack is rebuilt whole, and
    the spliced stacks equal fresh packs."""
    pair.same("cold")
    s_local = N_SHARDS // PARTS
    calls, real = _k15_calls()
    try:
        before = _counters()
        for s in range(s_local):
            pair.write(f"Set({s * SHARD_WIDTH + 11 + s}, f=1)")
        pair.same("40 shards of part 0")
        mid = _counters()
        assert [tuple(c[1].shape)[0] for c in calls] == [32, 8]
        assert all(c[0] is calls[0][0] for c in calls)
        assert sorted(i for c in calls for i in c[2].tolist()) == list(range(s_local))
        pair.write(f"Set({(s_local + 5) * SHARD_WIDTH + 9}, f=2)")
        pair.same("one shard of part 1")
        after = _counters()
    finally:
        cuda_mod.splice_slabs = real
    assert len(calls) == 3
    part, slabs, idx, valid = calls[2]
    assert tuple(slabs.shape)[0] == 1 and idx.tolist() == [5] and valid.tolist() == [1]
    assert part.data_ptr() != calls[0][0].data_ptr()
    # The meshed and the unmeshed backend both splice each epoch.
    assert mid["stack_full_rebuilds_total"] == before["stack_full_rebuilds_total"]
    assert after["stack_full_rebuilds_total"] == before["stack_full_rebuilds_total"]
    assert mid["stack_incremental_shards_total"] - before["stack_incremental_shards_total"] \
        == 2 * s_local
    slab = 8 * WORDS_PER_SHARD * 4
    assert mid["stack_update_bytes_total"] - before["stack_update_bytes_total"] \
        == 2 * s_local * slab
    assert after["stack_update_bytes_total"] - mid["stack_update_bytes_total"] == 2 * slab
    pair.stacks_equal_fresh_packs()


def test_rounds_stay_within_the_chunk_words(pair, monkeypatch):
    """A round also holds at most sparse.CHUNK_WORDS words: with chunks of
    two slabs, 5 dirty shards of one part take 3 calls (2, 2, 1)."""
    monkeypatch.setattr(sparse, "CHUNK_WORDS", 2 * 8 * WORDS_PER_SHARD)
    pair.same("cold")
    calls, real = _k15_calls()
    try:
        for s in range(5):
            pair.write(f"Set({(s + 3) * SHARD_WIDTH + 100}, f=3)")
        pair.same("5 shards of part 0")
    finally:
        cuda_mod.splice_slabs = real
    assert [tuple(c[1].shape)[0] for c in calls] == [2, 2, 1]
    pair.stacks_equal_fresh_packs()


def _entries(seed, c, s_local):
    """c entries with duplicate, invalid and clipped ones among them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, s_local + 3, c).astype(np.int32)
    idx[1] = idx[4] = idx[9]            # a target written three times
    idx[2], idx[3] = -7, s_local + 11   # clipped to the first and the last
    valid = (rng.random(c) < 0.75).astype(np.uint32)
    valid[9] = 0                        # the last write of that target invalid
    valid[2] = valid[3] = valid[4] = 1
    return idx, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_resolver_and_plain_form_equal_jax_splice_at_32_entries(seed):
    """At C = MAX_SPLICE_ENTRIES, the plain form and the live pairs of the
    host resolver (splice_pairs: distinct targets, applied in any order)
    both give the JAX package's splice_shard_slabs byte for byte."""
    c, s_local, rows, w = K.MAX_SPLICE_ENTRIES, 12, 2, 16
    rng = np.random.default_rng(seed + 100)
    block = rng.integers(0, 2**32, (s_local, rows, w), dtype=np.uint32)
    slabs = rng.integers(0, 2**32, (c, rows, w), dtype=np.uint32)
    idx, valid = _entries(seed, c, s_local)
    want = np.asarray(splice_shard_slabs(block, slabs, idx, valid)).tobytes()
    plain = torch.from_numpy(block.copy().view(np.int32))
    K.splice_slabs(plain, torch.from_numpy(slabs.view(np.int32)), idx, valid)
    assert plain.numpy().tobytes() == want
    src, tgt = K.splice_pairs(idx, valid.astype(bool), s_local)
    assert len(set(tgt.tolist())) == tgt.size and tgt.size < c
    assert all(valid[j] for j in src)
    resolved = block.copy()
    for j in np.random.default_rng(seed).permutation(src.size):
        resolved[tgt[j]] = slabs[src[j]]
    assert resolved.tobytes() == want


def test_resolver_keeps_the_last_valid_entry_of_each_target():
    src, tgt = K.splice_pairs(np.array([3, 0, 3, -2, 9, 3], dtype=np.int32),
                              np.array([1, 1, 1, 1, 1, 0], dtype=bool), 5)
    assert dict(zip(tgt.tolist(), src.tolist())) == {3: 2, 0: 3, 4: 4}
    src, tgt = K.splice_pairs(np.zeros(2, dtype=np.int32), np.zeros(2, dtype=bool), 5)
    assert src.size == tgt.size == 0


def test_splice_entries_accept_numpy_lists_and_tensors():
    """The wrapper takes the backend's numpy entries as they are, and the
    tests' lists and tensors."""
    block = torch.zeros((3, 1, 8), dtype=torch.int32)
    slabs = torch.arange(16, dtype=torch.int32).reshape(2, 1, 8)
    for idx, valid in (([2, 0], [1, 1]), (np.array([2, 0], dtype=np.int32),
                                          np.ones(2, dtype=np.uint32)),
                       (torch.tensor([2, 0]), torch.tensor([1, 1]))):
        got = block.clone()
        K.splice_slabs(got, slabs, idx, valid)
        assert torch.equal(got[2], slabs[0]) and torch.equal(got[0], slabs[1])
        assert not got[1].any()


def test_max_splice_entries_matches_the_kernel_source():
    """The limit the wrapper and the backend's rounds use is the size of
    the pair table in K15's launch parameters."""
    from pilosa_tpu_torch.ops import build

    with open(build.SOURCES["splice"]) as fh:
        found = re.findall(r"\bkMaxEntries = (\d+)\b", fh.read())
    assert len(found) == 1 and int(found[0]) == K.MAX_SPLICE_ENTRIES


class _Event:
    """A stand-in for a CUDA event: done only once synchronize() ran."""

    def __init__(self):
        self.done = False

    def synchronize(self):
        self.done = True

    def query(self):
        return self.done


def test_pool_hands_out_a_buffer_only_after_its_copy_event(monkeypatch):
    """A buffer given back with the event of its copy is handed out again
    only after that event is waited on; a new one is made while none is
    free."""
    monkeypatch.setattr(sparse, "_POOL", {})
    nbytes = 3 << 20
    buf = sparse._take_buffer(nbytes, False)
    assert buf.numel() == 4 << 20
    other = sparse._take_buffer(nbytes, False)
    assert other.data_ptr() != buf.data_ptr()
    event = _Event()
    sparse._give_buffer(buf, False, event)
    assert not event.done
    again = sparse._take_buffer(nbytes, False)
    assert again.data_ptr() == buf.data_ptr() and event.done


def test_splice_rounds_give_their_buffers_back(pair, monkeypatch):
    """Each round takes its staging buffer from the pool and gives it back,
    so a later round of the same size reuses it."""
    monkeypatch.setattr(sparse, "_POOL", {})
    pair.same("cold")
    taken = []
    real = sparse._take_buffer
    monkeypatch.setattr(sparse, "_take_buffer",
                        lambda n, pinned: taken.append(real(n, pinned)) or taken[-1])
    pair.write(f"Set({2 * SHARD_WIDTH + 5}, f=1)")
    pair.same("one write")
    pair.write(f"Set({3 * SHARD_WIDTH + 5}, f=1)")
    pair.same("another write")
    # Per epoch: the meshed round's slabs; the unmeshed round's slabs and
    # shard indices. The second epoch's buffers are the first's.
    assert len(taken) == 6
    assert [t.data_ptr() for t in taken[3:]] == [t.data_ptr() for t in taken[:3]]
    assert all(not t.is_pinned() for t in taken)


def test_kernel_source_resolves_no_entries():
    """K15's body takes live pairs: no barrier and no entry loop in it."""
    path = os.path.join(os.path.dirname(K.__file__), "csrc", "splice.cu")
    with open(path) as fh:
        text = fh.read()
    body = text[text.index("splice_slabs_kernel("):text.index("splice_floor_kernel")]
    assert "__syncthreads" not in body and "valid" not in body
    assert "__grid_constant__" in body
