"""Multi-node serving of the port on the CPU: cluster/ (sync, resize and
consistency), the executor's mapper and router seams, the backend's
per-shard calls and `cli server`'s cluster wiring, against the JAX
package's cluster on the same data.

Three two-node clusters are built on one seeded data set, each written
through its own nodes' APIs: the port's (a CUDABackend(device="cpu") a
node, the kernels' plain versions), the JAX package's with TPUBackend on
JAX's CPU a node, and the JAX package's on its CPU oracle. Every node of
the port's cluster must answer exactly as the same node of the other two,
at replicas 1 and 2. The port's harness is tests/torch_cluster_harness.py.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from pilosa_tpu.exec.result import result_to_json as jax_json
from pilosa_tpu.exec.tpu import TPUBackend
from pilosa_tpu_torch.cluster import InternalClient, Node, Topology, URI
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec.result import result_to_json
from pilosa_tpu_torch.server.http import Server
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.stats import global_stats
from tests.cluster_harness import FaultProxy, RewriteClient
from tests.cluster_harness import TestCluster as JaxCluster
from tests.torch_cluster_harness import PortCluster, await_topology
from tests.test_torch_backend import (
    ON_CARD_QUERIES,
    PAIR_REQUEST,
    ROUTED_QUERIES,
    SLICE_QUERIES,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain kernels' tensors here are small, and
    the port's test files run side by side. Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_device(i, holder):
    return TPUBackend(holder)


def _frag(cn, index, field, shard, view=VIEW_STANDARD):
    idx = cn.holder.index(index)
    f = idx.field(field) if idx else None
    v = f.view(view) if f else None
    return v.fragment(shard) if v else None


def _columns(out: dict) -> list:
    """The columns of a query's first result, a Row."""
    return result_to_json(out["results"][0])["columns"]


def _counter(prefix: str) -> float:
    return sum(global_stats.counter_totals(prefix).values())


def _routed(call: str) -> float:
    return global_stats.counter_totals("cpu_routed_total").get(
        f'cpu_routed_total{{call="{call}"}}', 0)


def _launches(backend) -> dict:
    """The backend's launches by kind (its program ledger, /debug/programs)."""
    out: dict = {}
    for e in backend.programs.ledger():
        out[e["kind"]] = out.get(e["kind"], 0) + e["launches"]
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


# ---------------------------------------------------------------------------
# the seeded data, written through each cluster's own API
# ---------------------------------------------------------------------------

N_SHARDS = 4


def populate(tc) -> None:
    """Index i: set fields f (rows 1-3), g (row 7) and h (rows 0-1), int
    field v in [-500, 500], over N_SHARDS shards, imported through both
    nodes (each import is routed to the shards' owners)."""
    rng = np.random.default_rng(19)
    tc.create_index("i")
    for name in ("f", "g", "h"):
        tc.create_field("i", name)
    tc.create_field("i", "v", {"type": "int", "min": -500, "max": 500})
    width = N_SHARDS * SHARD_WIDTH

    def cols(n):
        return np.unique(rng.integers(0, width, n, dtype=np.uint64)).tolist()

    for k, row in enumerate((1, 2, 3)):
        c = cols(600)
        tc[k % 2].api.import_bits("i", "f", [row] * len(c), c)
    c = cols(500)
    tc[1].api.import_bits("i", "g", [7] * len(c), c)
    c = cols(300)
    tc[0].api.import_bits("i", "h", rng.integers(0, 2, len(c)).tolist(), c)
    c = cols(120)
    tc[1].api.import_values("i", "v", c, rng.integers(-500, 501, len(c)).tolist())
    tc.await_shard_convergence("i")


# Besides tests/test_torch_backend.py's lists: a filtered 2-field GroupBy
# and a 3-field GroupBy (K2 and K4/K5 on a node's leg), and a Union and a
# Not the way chip_smoke.py's cluster phase sends them.
CLUSTER_QUERIES = (
    SLICE_QUERIES + ON_CARD_QUERIES + ROUTED_QUERIES + [PAIR_REQUEST] + [
        "GroupBy(Rows(f), Rows(g), filter=Row(h=1))",
        "GroupBy(Rows(f), Rows(g), Rows(h))",
        "Count(Union(Row(f=1), Row(g=7)))",
        "Count(Not(Row(h=1)))",
    ]
)


@pytest.fixture(scope="module", params=[1, 2], ids=["replicas1", "replicas2"])
def clusters(request):
    """(the port's cluster, the JAX TPUBackend cluster, the JAX oracle
    cluster), two nodes each, populated alike."""
    replicas = request.param
    made = []
    try:
        for make in (
            lambda: PortCluster(2, replica_n=replicas),
            lambda: JaxCluster(2, replica_n=replicas, backend_factory=jax_device),
            lambda: JaxCluster(2, replica_n=replicas),
        ):
            tc = make()
            made.append(tc)
            populate(tc)
        yield tuple(made)
    finally:
        for tc in made:
            tc.close()


def _answers(tc, node, q, encode):
    return [encode(r) for r in tc.query(node, "i", q)["results"]]


@pytest.mark.parametrize("node", [0, 1])
@pytest.mark.parametrize("q", CLUSTER_QUERIES)
def test_cluster_answers_equal_jax_cluster(clusters, q, node):
    port, jdev, jcpu = clusters
    want = _answers(jcpu, node, q, jax_json)
    assert _answers(jdev, node, q, jax_json) == want, q
    assert _answers(port, node, q, result_to_json) == want, q


def _remote_legs(cn) -> int:
    """Peers that a request over every shard sends a leg to."""
    shards = cn.holder.index("i").available_shards().to_array().tolist()
    groups = cn.cluster._shards_by_node(cn.cluster._routable_nodes("i", shards), "i", shards)
    return len([nid for nid in groups if nid != cn.node.id])


# (query, its call name, cpu_routed_total's increase for R remote legs),
# by the JAX package's guards: a clustered coordinator answers TopN, Rows,
# Sum, Min, Max and GroupBy on the host; its peers' legs answer TopN (both
# of its passes when n is set), Sum, Min and Max on the host and Rows and
# GroupBy on the card; Count and bitmap calls stay on the card throughout.
ROUTING = [
    ("Count(Row(f=1))", "Count", lambda r: 0),
    ("Count(Intersect(Row(f=1), Row(g=7)))", "Count", lambda r: 0),
    ("Row(f=2)", "Row", lambda r: 0),
    ("Count(Row(v > 100))", "Count", lambda r: 0),
    ("TopN(f)", "TopN", lambda r: 1 + r),
    ("TopN(f, n=2)", "TopN", lambda r: 1 + 2 * r),
    ("Sum(field=v)", "Sum", lambda r: 1 + r),
    ("Min(Row(g=7), field=v)", "Min", lambda r: 1 + r),
    ("Max(field=v)", "Max", lambda r: 1 + r),
    ("Rows(f)", "Rows", lambda r: 1),
    ("GroupBy(Rows(f), Rows(g), filter=Row(h=1))", "GroupBy", lambda r: 1),
]


@pytest.mark.parametrize("node", [0, 1])
@pytest.mark.parametrize("q,call,expect", ROUTING, ids=[r[0] for r in ROUTING])
def test_cpu_routed_follows_the_jax_guards(clusters, q, call, expect, node):
    port = clusters[0]
    r = _remote_legs(port[node])
    before_call = _routed(call)
    before = _counter("cpu_routed_total")
    port.query(node, "i", q)
    assert _routed(call) - before_call == expect(r), (q, r)
    assert _counter("cpu_routed_total") - before == expect(r), q


def test_count_launches_once_per_local_shard(clusters):
    """Part C's Count row: the coordinator's local leg launches K11 once a
    shard it serves, each peer once a shard of its leg (no batcher here)."""
    port = clusters[0]
    coord, peer = port[0], port[1]
    shards = coord.holder.index("i").available_shards().to_array().tolist()
    groups = coord.cluster._shards_by_node(coord.cluster.topology.nodes, "i", shards)
    local = len(groups.get(coord.node.id, (None, []))[1])
    remote = len(groups.get(peer.node.id, (None, []))[1])
    b0, p0 = _launches(coord.backend), _launches(peer.backend)
    port.query(0, "i", "Count(Intersect(Row(f=1), Row(g=7)))")
    assert _delta(_launches(coord.backend), b0) == ({"count": local} if local else {})
    assert _delta(_launches(peer.backend), p0) == ({"count": remote} if remote else {})


# ---------------------------------------------------------------------------
# part A: the faults a cluster exposes
# ---------------------------------------------------------------------------


def _spy_assembled(backend):
    """Record the shard tuple of every call tree the backend assembles."""
    seen = []
    real = backend._assemble

    def spy(index, c, shards):
        seen.append(tuple(shards))
        return real(index, c, shards)

    backend._assemble = spy
    return seen


@pytest.mark.parametrize("q", [
    "Sum(Row(f=1), field=v)", "Min(Row(g=7), field=v)", "TopN(f, Row(g=7), n=2)",
    "Count(Intersect(Row(f=1), Row(g=7)))", "Row(f=3)",
])
def test_coordinator_assembles_only_the_shards_it_holds(q):
    """At replicas 1 each node holds only its own shards. A clustered
    coordinator evaluates a filter, a Count and a Row per shard of its own
    leg, over stacks of the shards it holds: never over its peers'."""
    with PortCluster(2) as port, JaxCluster(2) as ref:
        for tc in (port, ref):
            populate(tc)
        for node in (0, 1):
            cn = port[node]
            held = {s for s in range(N_SHARDS)
                    if cn.cluster.topology.owns_shard(cn.node.id, "i", s)}
            assert held and len(held) < N_SHARDS
            seen = _spy_assembled(cn.backend)
            got = _answers(port, node, q, result_to_json)
            assert got == _answers(ref, node, q, jax_json), q
            assert seen, q
            assert all(set(t) <= held for t in seen), (q, held, seen)


def test_repeated_clustered_counts_keep_one_resident_stack():
    """The coordinator's local leg calls count_shard once a shard. Each
    call reads its shard's slab of ONE resident stack a field: repeated
    Counts leave stack_full_rebuilds_total flat and the entry's shard tuple
    unchanged, on both nodes."""
    with PortCluster(2, replica_n=2) as port:
        populate(port)
        port.query(0, "i", "Count(Intersect(Row(f=1), Row(g=7)))")
        port.query(1, "i", "Count(Intersect(Row(f=1), Row(g=7)))")
        tuples = [{k: e[0][0] for k, e in cn.backend.blocks._entries.items()}
                  for cn in port.nodes]
        rebuilds = _counter("stack_full_rebuilds_total")
        for _ in range(3):
            for node in (0, 1):
                assert port.query(node, "i", "Count(Intersect(Row(f=1), Row(g=7)))")
                port.query(node, "i", "Count(Row(f=2))")
        assert _counter("stack_full_rebuilds_total") == rebuilds
        assert [{k: e[0][0] for k, e in cn.backend.blocks._entries.items()}
                for cn in port.nodes] == tuples
        for t in tuples:
            assert t and all(len(s) > 1 for s in t.values())


def test_remote_leg_subset_keeps_one_stack_per_field():
    """A node's legs pin its own shard subset (remote=true). Per-shard
    calls, row resolves and Counts over that subset then share one resident
    stack a field with it, request after request."""
    with PortCluster(2, replica_n=2) as port:
        populate(port)
        cn = port[1]
        subset = [s for s in range(N_SHARDS)
                  if cn.cluster.topology.primary_for_shard("i", s).id == cn.node.id]
        assert subset
        q = "Count(Intersect(Row(f=1), Row(g=7))) Count(Row(f=2)) Row(f=3)"
        cn.api.query("i", q, shards=subset, remote=True)
        port.query(1, "i", "Count(Row(f=1))")
        keys = {k: e[0][0] for k, e in cn.backend.blocks._entries.items()}
        rebuilds = _counter("stack_full_rebuilds_total")
        for _ in range(3):
            cn.api.query("i", q, shards=subset, remote=True)
            port.query(1, "i", "Count(Row(f=1))")
            port.query(0, "i", "Row(f=1)")
        assert _counter("stack_full_rebuilds_total") == rebuilds
        assert {k: e[0][0] for k, e in cn.backend.blocks._entries.items()} == keys


def test_per_shard_resident_lookup_is_memoized():
    """The coordinator's per-shard calls find their resident stack through
    a memo: repeated lookups walk the resident stacks no more, a stored
    stack makes the next request walk them once (not once a shard), and a
    new shard gives a new held tuple that covers it."""
    with PortCluster(2, replica_n=2) as port:
        populate(port)
        cn = port[0]
        q = "Count(Intersect(Row(f=1), Row(g=7)))"
        want = port.query(0, "i", q)["results"]
        be = cn.backend
        walks = []
        real = be.blocks.resident_shard_sets

        def spy(index):
            walks.append(index)
            return real(index)

        be.blocks.resident_shard_sets = spy
        held = be._held("i")
        assert held == tuple(range(N_SHARDS)) and be._held("i") is held
        resident = {e[0][0] for e in be.blocks._entries.values()}
        for _ in range(3):
            for s in held:
                cand, (pos,) = be._resident_shards("i", [s])
                assert cand[pos] == s and cand in resident
            assert port.query(0, "i", q)["results"] == want
        assert walks == []
        port.query(0, "i", f"Set({held[0] * SHARD_WIDTH + 3}, f=1)")
        port.query(0, "i", q)
        assert 1 <= len(walks) <= 2
        walks.clear()
        for s in held:
            be._resident_shards("i", [s])
        assert walks == []
        port.query(0, "i", f"Set({N_SHARDS * SHARD_WIDTH + 1}, g=7)")
        assert be._held("i") == tuple(range(N_SHARDS + 1))
        cand, (pos,) = be._resident_shards("i", [N_SHARDS])
        assert cand[pos] == N_SHARDS and walks == ["i"]


# ---------------------------------------------------------------------------
# scenarios (tests/test_cluster.py, tests/test_cluster2.py) on both packages
# ---------------------------------------------------------------------------


def _both(replica_n=1, jax_factory=jax_device):
    return PortCluster(2, replica_n=replica_n), JaxCluster(2, replica_n=replica_n,
                                                           backend_factory=jax_factory)


def _same_everywhere(port, ref, queries):
    for q in queries:
        for node in (0, 1):
            want = _answers(ref, node, q, jax_json)
            assert _answers(port, node, q, result_to_json) == want, (q, node)


def test_writes_reach_every_replica_and_import_routes_to_owners():
    port, ref = _both(replica_n=2)
    with port, ref:
        for tc in (port, ref):
            tc.create_index("i")
            tc.create_field("i", "f")
            tc.query(1, "i", "Set(5, f=1)")
            cols = [s * SHARD_WIDTH + 11 for s in range(N_SHARDS)]
            tc[0].api.import_bits("i", "f", [2] * len(cols), cols)
            tc.await_shard_convergence("i")
            for s in range(N_SHARDS):
                for owner in tc[0].cluster.topology.shard_nodes("i", s):
                    cn = next(n for n in tc.nodes if n.node.id == owner.id)
                    f = cn.holder.index("i").field("f")
                    assert f.row(2, s).includes_column(cols[s]), (s, owner.id)
            for owner in tc[0].cluster.topology.shard_nodes("i", 0):
                cn = next(n for n in tc.nodes if n.node.id == owner.id)
                assert cn.holder.index("i").field("f").row(1, 0).includes_column(5)
        _same_everywhere(port, ref, ["Count(Row(f=2))", "Row(f=1)", "TopN(f)"])
        for tc in (port, ref):
            tc.query(0, "i", "Clear(5, f=1)")
        _same_everywhere(port, ref, ["Row(f=1)", "Count(Row(f=1))"])


class PortRewriteClient(InternalClient):
    """tests/cluster_harness.py's RewriteClient over the port's client:
    dials selected peers through a FaultProxy."""

    def __init__(self, rewrites: dict, timeout: float = 0.5, **kw):
        super().__init__(timeout=timeout, **kw)
        self.rewrites = rewrites

    def _connect_uri(self, uri) -> str:
        u = super()._connect_uri(uri)
        scheme, _, hostport = u.partition("://")
        mapped = self.rewrites.get(hostport)
        return f"{scheme}://{mapped}" if mapped is not None else u


def _refuse_peer(tc, client_cls):
    """Route node 0's calls to node 1 through a FaultProxy that refuses
    every connection; returns the proxy."""
    target = tc[1].node.uri
    proxy = FaultProxy(target.host, target.port)
    rc = client_cls({f"{target.host}:{target.port}": f"127.0.0.1:{proxy.port}"})
    rc.on_peer_epochs = tc[0].cluster.fold_peer_epochs
    tc[0].cluster.client = rc
    proxy.mode = "refuse"
    return proxy


@pytest.mark.parametrize("replica_n", [1, 2])
def test_count_survives_a_down_node_and_unreplicated_shard_raises(replica_n):
    """Node 1 refuses node 0's connections. At replicas 2 node 0 re-splits
    node 1's shards onto itself and answers as the JAX cluster does; at
    replicas 1 a shard only node 1 holds raises a clean APIError."""
    from pilosa_tpu.server.api import APIError as JaxAPIError
    from pilosa_tpu_torch.server.api import APIError

    port, ref = _both(replica_n=replica_n)
    proxies = []
    try:
        for tc in (port, ref):
            populate(tc)
        proxies = [_refuse_peer(port, PortRewriteClient), _refuse_peer(ref, RewriteClient)]
        queries = ["Count(Row(f=1))", "Row(f=2)", "Sum(field=v)", "TopN(f, n=2)"]
        if replica_n == 2:
            for q in queries:
                want = _answers(ref, 0, q, jax_json)
                assert _answers(port, 0, q, result_to_json) == want, q
        else:
            assert any(port[0].cluster.topology.primary_for_shard("i", s).id == "node1"
                       for s in range(N_SHARDS))
            for q in queries:
                with pytest.raises(JaxAPIError):
                    ref.query(0, "i", q)
                with pytest.raises(APIError):
                    port.query(0, "i", q)
    finally:
        for pr in proxies:
            pr.close()
        port.close()
        ref.close()


def test_ddl_broadcast_and_queued_broadcast_flushed():
    port, ref = _both()
    with port, ref:
        for tc, server_cls in ((port, Server), (ref, None)):
            tc.create_index("idx1")
            tc.create_field("idx1", "fld1")
            for cn in tc.nodes:
                assert cn.holder.index("idx1").field("fld1") is not None
            port_no = tc[1].server.port
            tc[1].server.close()
            tc.create_index("late")  # the broadcast fails: queued
            assert tc[0].cluster._pending_msgs
            if server_cls is None:
                from pilosa_tpu.server.http import Server as server_cls
            tc[1].server = server_cls(tc[1].api, host="127.0.0.1", port=port_no).open()
            tc[0].cluster.flush_pending_broadcasts()
            assert not tc[0].cluster._pending_msgs
            assert tc[1].holder.index("late") is not None


def test_anti_entropy_heals_device_results():
    """Repair writes go through the fragment mutators, so view generations
    move: the device-backed stacks on both nodes serve the healed bit."""
    port, ref = _both(replica_n=2)
    with port, ref:
        for tc in (port, ref):
            tc.create_index("i")
            tc.create_field("i", "f")
            tc.query(0, "i", "Set(1, f=3) Set(100, f=3)")
            for node in (0, 1):
                assert tc.query(node, "i", "Count(Row(f=3))")["results"][0] == 2
            _frag(tc[0], "i", "f", 0).set_bit(3, 777)
            assert tc.sync_all() > 0
        for node in (0, 1):
            assert _columns(port.query(node, "i", "Row(f=3)")) == [1, 100, 777]
        _same_everywhere(port, ref, ["Row(f=3)", "Count(Row(f=3))"])
        # The remote legs' whole-query path too (remote=true, pinned shards).
        for cn in port.nodes:
            out = cn.api.query("i", "Count(Row(f=3))", shards=[0], remote=True)
            assert out["results"] == [3]


def test_divergence_monitor_repairs_a_diverged_replica():
    from pilosa_tpu.cluster.consistency import DivergenceMonitor as JaxMonitor
    from pilosa_tpu_torch.cluster.consistency import DivergenceMonitor

    port, ref = _both(replica_n=2)
    with port, ref:
        for tc, monitor in ((port, DivergenceMonitor), (ref, JaxMonitor)):
            tc.create_index("i")
            tc.create_field("i", "f")
            tc.query(0, "i", "Set(5, f=1) Set(9, f=1)")
            tc.await_shard_convergence("i")
            # A clear that reached one replica only.
            _frag(tc[1], "i", "f", 0).clear_bit(1, 5)
            mon = monitor(tc[0].cluster, max_queue=8).start()
            try:
                mon.observe("i", [0], "node0", "node1")
                deadline = time.monotonic() + 10
                while _frag(tc[0], "i", "f", 0).row_count(1) != 1:
                    assert time.monotonic() < deadline, "read repair never converged"
                    time.sleep(0.02)
                assert mon.debug_dump()["entries"]
            finally:
                mon.stop()
            assert _frag(tc[1], "i", "f", 0).row_count(1) == 1
        _same_everywhere(port, ref, ["Row(f=1)", "Count(Row(f=1))"])
        for cn in port.nodes:
            assert _columns(cn.api.query("i", "Row(f=1)", shards=[0], remote=True)) == [9]


def test_failure_detector_marks_down_and_queries_survive():
    from pilosa_tpu_torch.cluster.sync import FailureDetector

    with PortCluster(2, replica_n=2) as port:
        populate(port)
        want = port.query(0, "i", "Count(Row(f=1))")["results"][0]
        port[1].server.close()
        det = FailureDetector(port[0].cluster, confirm_down=2)
        det.probe_once()
        det.probe_once()
        peer = port[0].cluster.topology.node_by_id(port[1].node.id)
        assert peer.state == "DOWN" and port[0].cluster.state() == "DEGRADED"
        rebuilds = _counter("stack_full_rebuilds_total")
        assert port.query(0, "i", "Count(Row(f=1))")["results"][0] == want
        # The survivor now folds every shard itself, over the stacks it
        # already held (it holds every shard at replicas 2).
        assert port.query(0, "i", "Count(Row(f=1))")["results"][0] == want
        assert _counter("stack_full_rebuilds_total") - rebuilds <= 4


def test_write_after_a_replica_dies_fails_until_it_is_marked_down():
    """A write whose other replica stopped answering is answered 502, in
    both packages, until the failure detector marks that replica DOWN
    (the survivor's own leg ran first, so its copy holds the bit); then
    the survivor takes the write alone and answers it. chip_smoke.py's
    cluster phase waits for the DOWN before its heal write for this."""
    from pilosa_tpu.cluster.sync import FailureDetector as JaxDetector
    from pilosa_tpu.server.api import APIError as JaxAPIError
    from pilosa_tpu_torch.cluster.sync import FailureDetector
    from pilosa_tpu_torch.server.api import APIError

    shard = 1
    port, ref = _both(replica_n=2)
    with port, ref:
        for tc, detector, error in ((port, FailureDetector, APIError),
                                    (ref, JaxDetector, JaxAPIError)):
            populate(tc)
            held = set(_columns(tc[0].api.query("i", "Row(f=1)", shards=[shard], remote=True)))
            col = next(c for c in range(shard * SHARD_WIDTH, (shard + 1) * SHARD_WIDTH)
                       if c not in held)
            tc[1].server.close()
            with pytest.raises(error) as refused:
                tc.query(0, "i", f"Set({col}, f=1)")
            assert refused.value.status == 502
            got = _columns(tc[0].api.query("i", "Row(f=1)", shards=[shard], remote=True))
            assert sorted(got) == sorted(held | {col})
            det = detector(tc[0].cluster, confirm_down=2)
            det.probe_once()
            det.probe_once()
            assert tc[0].cluster.topology.node_by_id(tc[1].node.id).state == "DOWN"
            assert tc.query(0, "i", f"Set({col}, f=1)")["results"] == [False]
            assert tc.query(0, "i", f"Clear({col}, f=1)")["results"] == [True]
            got = _columns(tc[0].api.query("i", "Row(f=1)", shards=[shard], remote=True))
            assert sorted(got) == sorted(held)


# ---------------------------------------------------------------------------
# carry and the CLI
# ---------------------------------------------------------------------------


def test_jax_written_topology_loads_in_the_port(tmp_path):
    """A .topology written by the JAX package loads in the port with the
    same node ids, replicaN, partitionN and resizeEpoch."""
    from pilosa_tpu.cluster import Node as JNode, Topology as JTopology, URI as JURI
    from pilosa_tpu.cluster.topology import save_topology as jsave
    from pilosa_tpu_torch.cluster.topology import TOPOLOGY_FILE, load_topology

    nodes = [JNode(id=f"node-{i}", uri=JURI(host="127.0.0.1", port=10101 + i),
                   is_coordinator=(i == 0)) for i in range(3)]
    path = str(tmp_path / TOPOLOGY_FILE)
    jsave(path, JTopology(nodes, replica_n=2, partition_n=64), "node-1", resize_epoch=7)
    saved = load_topology(path)
    assert [Node.from_json(d).id for d in saved["nodes"]] == ["node-0", "node-1", "node-2"]
    assert (saved["replicaN"], saved["partitionN"], saved["resizeEpoch"]) == (2, 64, 7)
    topo = Topology([Node.from_json(d) for d in saved["nodes"]],
                    replica_n=saved["replicaN"], partition_n=saved["partitionN"])
    jtopo = JTopology(nodes, replica_n=2, partition_n=64)
    for s in range(32):
        assert ([n.id for n in topo.shard_nodes("i", s)]
                == [n.id for n in jtopo.shard_nodes("i", s)])


class _Booted(Exception):
    """Raised where the server would bind: the wiring is done."""


def _boot_cli(tmp_path, monkeypatch, toml="", argv=(), bind="127.0.0.1:10101"):
    """Run `cli server --executor=cpu` up to the bind; returns (its API, the
    cluster wired onto it or None, {daemon class name: the daemon} of the
    daemons it started (recorded, not run), the names of the threads it
    spawned)."""
    from pilosa_tpu_torch import cli
    from pilosa_tpu_torch.cluster import consistency, sync
    from pilosa_tpu_torch.server import http as http_mod
    from pilosa_tpu_torch.utils import monitor
    from pilosa_tpu_torch.utils import threads as threads_mod

    built, daemons, spawned = {}, {}, []

    def capture(self, api, *a, **k):
        built["api"] = api
        raise _Booted

    def record(self):
        daemons[type(self).__name__] = self
        return self

    monkeypatch.setattr(http_mod.Server, "__init__", capture)
    for cls in (sync.SyncDaemon, sync.FailureDetector, consistency.DivergenceMonitor,
                monitor.RuntimeMonitor):
        monkeypatch.setattr(cls, "start", record)
    real_spawn = threads_mod.spawn
    monkeypatch.setattr(threads_mod, "spawn",
                        lambda name, *a, **k: spawned.append(name) or real_spawn(name, *a, **k))
    conf = tmp_path / "c.toml"
    conf.write_text(toml)
    with pytest.raises(_Booted):
        cli.main(["server", "-d", str(tmp_path / "d"), "--bind", bind, "-c", str(conf),
                  "--executor", "cpu", *argv])
    return built["api"], built["api"].cluster, daemons, spawned


CLUSTER_TOML = '[cluster]\nhosts = ["127.0.0.1:10101", "127.0.0.1:10102"]\n'

#: Each cluster setting, its TOML, and what it sets on the wired cluster.
SETTINGS = {
    "anti-entropy.interval": ("[anti-entropy]\ninterval = 60.0\n",
                              lambda cl, d: d["sync"].interval == 60.0),
    "client-timeout": ("client-timeout = 5.0\n", lambda cl, d: cl.client.timeout == 5.0),
    "client-retries": ("client-retries = 3\n", lambda cl, d: cl.client.retries == 3),
    "breaker-threshold": ("breaker-threshold = 5\n",
                          lambda cl, d: cl.client.breakers.threshold == 5),
    "breaker-cooldown": ("breaker-cooldown = 2.0\n",
                         lambda cl, d: cl.client.breakers.cooldown == 2.0),
    "hedge-delay": ("hedge-delay = 0.0\n", lambda cl, d: cl.hedge_delay == 0.0),
    "resize-lease": ("resize-lease = 30.0\n", lambda cl, d: cl.resizer.lease_timeout == 30.0),
    "migration-concurrency": ("migration-concurrency = 4\n",
                              lambda cl, d: cl.resizer.fetch_concurrency == 4),
    "migration-bandwidth": ("migration-bandwidth = 1000000\n",
                            lambda cl, d: cl.resizer.bandwidth_limit == 1000000),
    "read-repair-queue": ("read-repair-queue = 0\n", lambda cl, d: "divergence" not in d),
    "cluster.coordinator": ("coordinator = true\n",
                            lambda cl, d: cl.is_coordinator()
                            and cl.coordinator().id == "node-127.0.0.1-10102"),
    "cluster.replicas": ("replicas = 2\n", lambda cl, d: cl.topology.replica_n == 2),
    "tls.skip-verify": ("[tls]\nskip-verify = true\n",
                        lambda cl, d: cl.client.ssl_context is not None),
}


@pytest.mark.parametrize("key", sorted(SETTINGS))
def test_cli_serves_cluster_setting(tmp_path, monkeypatch, key):
    """`cli server` with cluster.hosts wires a cluster onto the executor,
    starts anti-entropy, the failure detector and the divergence monitor,
    and each cluster setting reaches the cluster, its client, its resizer
    or a daemon."""
    toml, check = SETTINGS[key]
    body = CLUSTER_TOML + toml if key.startswith("cluster.") else toml + CLUSTER_TOML
    api, cl, daemons, _ = _boot_cli(tmp_path, monkeypatch, body, bind="127.0.0.1:10102")
    try:
        assert cl is not None and len(cl.topology.nodes) == 2
        assert api.executor.mapper == cl.map_shards and api.executor.router is cl
        assert api.executor.backend.__class__.__name__ == "CPUBackend"
        assert {"SyncDaemon", "FailureDetector"} <= set(daemons)
        found = {"sync": daemons["SyncDaemon"]}
        if "DivergenceMonitor" in daemons:
            found["divergence"] = daemons["DivergenceMonitor"]
        assert check(cl, found), key
    finally:
        api.holder.close()


def test_cli_join_and_persisted_topology(tmp_path, monkeypatch):
    """--join boots a one-node cluster that announces after the bind; a
    persisted multi-node .topology (no cluster config) restores the
    cluster with its members, replicas and resize epoch."""
    api, cl, daemons, spawned = _boot_cli(tmp_path, monkeypatch,
                                          argv=["--join", "http://127.0.0.1:1"])
    try:
        assert cl is not None and [n.id for n in cl.topology.nodes] == ["node-127.0.0.1-10101"]
        assert {"SyncDaemon", "FailureDetector", "DivergenceMonitor"} <= set(daemons)
        assert "cluster-announce" not in spawned  # the announce follows the bind
    finally:
        api.holder.close()

    from pilosa_tpu_torch.cluster.topology import TOPOLOGY_FILE, save_topology

    data_dir = tmp_path / "d"
    nodes = [Node(id=f"node-127.0.0.1-{p}", uri=URI(host="127.0.0.1", port=p))
             for p in (10101, 10102)]
    save_topology(os.path.join(data_dir, TOPOLOGY_FILE), Topology(nodes, replica_n=2),
                  "node-127.0.0.1-10101", resize_epoch=5)
    api, cl, _, _ = _boot_cli(tmp_path, monkeypatch)
    try:
        assert [n.id for n in cl.topology.nodes] == [n.id for n in nodes]
        assert cl.topology.replica_n == 2 and cl.resizer._epoch == 5
        assert api.executor.mapper == cl.map_shards
    finally:
        api.holder.close()


def test_cli_bind_outside_hosts_exits_nonzero(tmp_path, monkeypatch, capsys):
    from pilosa_tpu_torch import cli

    conf = tmp_path / "c.toml"
    conf.write_text(CLUSTER_TOML)
    rc = cli.main(["server", "-d", str(tmp_path / "d"), "--bind", "127.0.0.1:10199",
                   "-c", str(conf), "--executor", "cpu"])
    assert rc == 1
    assert "is not in cluster.hosts" in capsys.readouterr().err


def test_cli_cluster_subprocess_serves_and_stops(tmp_path):
    """Two `cli server --executor=cpu` processes with cluster.hosts answer
    one Count together, from either node, and exit 0 on SIGINT."""
    import json
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request

    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    hosts = ", ".join(f'"127.0.0.1:{p}"' for p in ports)
    conf = tmp_path / "c.toml"
    conf.write_text(f"[cluster]\nhosts = [{hosts}]\nreplicas = 2\n"
                    "[anti-entropy]\ninterval = 5.0\n")
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-d", str(tmp_path / f"n{k}"),
         "--bind", f"127.0.0.1:{p}", "-c", str(conf), "--executor", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for k, p in enumerate(ports)]

    def call(port, method, path, body=b""):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body or None,
                                     method=method)
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read() or b"null")

    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                for p in ports:
                    call(p, "GET", "/status")
                break
            except OSError:
                assert time.monotonic() < deadline, "the nodes never came up"
                time.sleep(0.2)
        call(ports[0], "POST", "/index/i", b"{}")
        call(ports[0], "POST", "/index/i/field/f", b"{}")
        call(ports[1], "POST", "/index/i/query",
             f"Set(3, f=1) Set({SHARD_WIDTH + 4}, f=1)".encode())
        for p in ports:
            assert call(p, "POST", "/index/i/query", b"Count(Row(f=1))")["results"] == [2]
    finally:
        for pr in procs:
            pr.send_signal(signal.SIGINT)
        logs = []
        for pr in procs:
            try:
                out, _ = pr.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                pr.kill()
                out, _ = pr.communicate()
            logs.append(out.decode(errors="replace"))
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log
        assert "clustered: 2 nodes, replicas=2" in log, log
        assert "Traceback" not in log, log
