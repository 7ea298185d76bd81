"""Resize of a port cluster on the CPU (cluster/resize.py): a node added or
removed through the coordinator's resize job, against the JAX package's
cluster doing the same. Answers are equal before and after on every node,
a migrated shard is served from the migrated fragment, and no node keeps a
stack over shards it no longer holds."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.ops.blocks import pack_fragment
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from tests.cluster_harness import TestCluster as JaxCluster
from tests.test_torch_cluster import _frag, jax_device
from tests.torch_cluster_harness import PortCluster, await_topology

N_SHARDS = 8

QUERIES = [
    "Count(Row(f=1))", "Row(f=2)", "Count(Intersect(Row(f=1), Row(f=2)))",
    "TopN(f, n=2)", "Sum(field=v)", "Max(field=v)", "Rows(f)", "GroupBy(Rows(f))",
    "Count(Row(v > 500))",
]
#: Read from a BSI field. The JAX package's migration keeps a field's bit
#: depth as it was on the receiving node (0 on a joiner), so after a resize
#: its cluster answers these from truncated values. The port's migration
#: grows the depth to the migrated planes (cluster/resize.py
#: _grow_bsi_depth): its answers after the resize stay those from before,
#: and _check_after pins that the JAX cluster's differ.
BSI_QUERIES = {"Sum(field=v)", "Max(field=v)", "Count(Row(v > 500))"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def populate(tc) -> None:
    """f rows 1 and 2 and int field v over N_SHARDS shards, imported through
    node 0 and routed to the owners (tests/test_cluster2.py's resize data,
    with a second row and values)."""
    rng = np.random.default_rng(3)
    tc.create_index("i")
    tc.create_field("i", "f")
    tc.create_field("i", "v", {"type": "int", "min": 0, "max": 1000})
    cols = list(range(0, N_SHARDS * SHARD_WIDTH, SHARD_WIDTH // 2))
    tc[0].api.import_bits("i", "f", [1] * len(cols), cols)
    more = np.unique(rng.integers(0, N_SHARDS * SHARD_WIDTH, 200, dtype=np.uint64)).tolist()
    tc[0].api.import_bits("i", "f", [2] * len(more), more)
    tc[0].api.import_values("i", "v", more[:40], rng.integers(0, 1001, 40).tolist())
    tc.await_shard_convergence("i")


def _answers(tc, node, encode):
    return {q: [encode(r) for r in tc.query(node, "i", q)["results"]] for q in QUERIES}


def _check_after(port_got, ref_got, want, node):
    """After a resize: the port's answers are those from before; the JAX
    cluster's agree with them but on the BSI queries, where its truncated
    depth gives other answers."""
    assert port_got == want, node
    for q in QUERIES:
        if q in BSI_QUERIES:
            assert ref_got[q] != want[q], (q, node)
        else:
            assert ref_got[q] == want[q], (q, node)


def _assert_held_stacks(cn):
    """Every resident stack of the node lies over shards it holds."""
    topo = cn.cluster.topology
    for key, entry in cn.backend.blocks._entries.items():
        assert all(topo.owns_shard(cn.node.id, key[0], s) for s in entry[0][0]), (
            cn.node.id, key, entry[0][0])


def test_add_node_answers_equal_and_migrated_shards_serve_their_fragments():
    port = PortCluster(2)
    ref = JaxCluster(2, backend_factory=jax_device)
    with port, ref:
        for tc in (port, ref):
            populate(tc)
        want = _answers(ref, 0, jax_json)
        for node in (0, 1):
            assert _answers(port, node, result_to_json) == want  # primes the stacks
        joined = port.add_node_via_resize()
        ref.add_node_via_resize()
        for node in range(3):
            _check_after(_answers(port, node, result_to_json), _answers(ref, node, jax_json),
                         want, node)
        topo = joined.cluster.topology
        owned = [s for s in range(N_SHARDS) if topo.owns_shard(joined.node.id, "i", s)]
        assert owned and all(_frag(joined, "i", "f", s) is not None for s in owned)
        # The joiner's stack of f: each migrated shard's slab is the pack of
        # the fragment it fetched, and a pinned leg reads it.
        block, rows_p = joined.backend.blocks.get(
            "i", joined.holder.index("i").field("f"), joined.backend._held("i"))
        shards_t = joined.backend._held("i")
        assert tuple(shards_t) == tuple(owned)
        for k, s in enumerate(shards_t):
            frag = _frag(joined, "i", "f", s)
            assert np.array_equal(block[k].numpy().view(np.uint32),
                                  pack_fragment(frag, n_rows=rows_p)), s
            got = joined.api.query("i", "Row(f=1)", shards=[s], remote=True)["results"][0]
            assert result_to_json(got)["columns"] == [s * SHARD_WIDTH,
                                                      s * SHARD_WIDTH + SHARD_WIDTH // 2]
        for cn in port.nodes:
            _assert_held_stacks(cn)


def test_remove_node_answers_equal():
    port = PortCluster(3)
    ref = JaxCluster(3, backend_factory=jax_device)
    with port, ref:
        for tc in (port, ref):
            populate(tc)
        want = _answers(ref, 0, jax_json)
        for node in range(3):
            assert _answers(port, node, result_to_json) == want
        rests = []
        for tc in (port, ref):
            victim = next(cn for cn in tc.nodes[1:] if not cn.cluster.is_coordinator())
            tc[0].cluster.resizer.remove_node(victim.node.id)
            rest = [cn for cn in tc.nodes if cn is not victim]
            await_topology(rest, 2)
            assert victim.cluster.state() == "NORMAL"
            rests.append(rest)
        for cn, jn in zip(*rests):
            got = {q: [result_to_json(r) for r in cn.api.query("i", q)["results"]]
                   for q in QUERIES}
            ref_got = {q: [jax_json(r) for r in jn.api.query("i", q)["results"]]
                       for q in QUERIES}
            _check_after(got, ref_got, want, cn.node.id)
            _assert_held_stacks(cn)


def test_abort_resets_state():
    with PortCluster(2) as port:
        port[0].cluster.set_state("RESIZING")
        port[1].cluster.set_state("RESIZING")
        port[0].cluster.resizer.abort()
        deadline = time.monotonic() + 5
        while port[0].cluster.state() != "NORMAL":
            assert time.monotonic() < deadline
            time.sleep(0.02)


def test_single_node_import_roaring_keeps_bsi_depth_as_jax(tmp_path):
    """Outside a resize the port's Field.import_roaring is the JAX one: a
    BSI view imported whole leaves the receiving field's bit depth as it
    was, and the values read back at that depth agree. Only the resize's
    migration grows the depth."""
    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.core.field import options_for_int as jax_options_for_int
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.field import options_for_int
    from pilosa_tpu_torch.core.view import bsi_view_name
    from pilosa_tpu_torch.roaring import serialize

    cols = np.arange(0, 60, 3, dtype=np.uint64)
    vals = np.random.default_rng(5).integers(0, 1001, cols.size)
    got = []
    for k, (holder_cls, opts) in enumerate(((Holder, options_for_int),
                                            (JaxHolder, jax_options_for_int))):
        src = holder_cls(str(tmp_path / f"src{k}")).open()
        dst = holder_cls(str(tmp_path / f"dst{k}")).open()
        for h in (src, dst):
            h.create_index("i").create_field("v", opts(0, 1000))
        src.index("i").field("v").import_value(cols, vals)
        frag = src.index("i").field("v").view(bsi_view_name("v")).fragment(0)
        f = dst.index("i").field("v")
        f.import_roaring(0, serialize(frag.storage), view_name=bsi_view_name("v"))
        got.append((f.options.bit_depth, f.value(int(cols[1]))))
        src.close()
        dst.close()
    assert got[0] == got[1]
    assert got[0][0] == 0
