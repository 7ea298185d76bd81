"""The port's in-process multi-node cluster: an import-rewritten copy of
tests/cluster_harness.py's ClusterNode and TestCluster over
pilosa_tpu_torch, n real servers in one process on ephemeral ports with a
static topology. Each node's backend comes from ``backend_factory(i,
holder)``: the port's CUDABackend on the CPU by default (the kernels'
plain versions), on the card where a test passes one. Imports no JAX."""

from __future__ import annotations

import shutil
import tempfile
import time

from pilosa_tpu_torch.cluster import Cluster, Node, Topology, URI
from pilosa_tpu_torch.cluster.topology import JmpHasher
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.exec.cuda import CUDABackend
from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.server.api import API
from pilosa_tpu_torch.server.http import Server


def card_on_cpu(i, holder):
    """A node's backend: the port's CUDABackend on the CPU."""
    return CUDABackend(holder, device="cpu")


class PortNode:
    """One node: holder, executor, API and a bound server."""

    def __init__(self, i: int, data_dir: str, backend_factory=card_on_cpu):
        self.i = i
        self.data_dir = data_dir
        self.holder = Holder(data_dir).open()
        self.executor = Executor(self.holder, backend=backend_factory(i, self.holder))
        self.api = API(self.holder, self.executor)
        self.server = Server(self.api, host="127.0.0.1", port=0).open()
        self.node = Node(
            id=f"node{i}",
            uri=URI(scheme=self.server.scheme, host="127.0.0.1", port=self.server.port),
            is_coordinator=(i == 0),
        )
        self.cluster = None  # attached by PortCluster

    @property
    def backend(self):
        return self.executor.backend

    def close(self) -> None:
        self.server.close()
        self.holder.close()


class PortCluster:
    """n wired port nodes sharing one static topology."""

    __test__ = False

    def __init__(self, n: int, replica_n: int = 1, backend_factory=card_on_cpu):
        self._tmp = tempfile.mkdtemp(prefix="pilosa-torch-cluster-")
        self._replica_n = replica_n
        self._hasher = JmpHasher()
        self._backend_factory = backend_factory
        self._next_i = n
        self.nodes = [PortNode(i, f"{self._tmp}/node{i}", backend_factory)
                      for i in range(n)]
        members = [cn.node for cn in self.nodes]
        for cn in self.nodes:
            self._wire(cn, members)

    def _wire(self, cn: PortNode, members) -> None:
        topo = Topology(
            nodes=[Node(m.id, m.uri, m.is_coordinator) for m in members],
            replica_n=self._replica_n,
            hasher=self._hasher,
        )
        cn.cluster = Cluster(local_node=topo.node_by_id(cn.node.id), topology=topo,
                             holder=cn.holder)
        cn.cluster.attach(cn.executor, cn.api)
        cn.api.cluster = cn.cluster
        cn.cluster.attach_resizer()

    def spawn_node(self) -> PortNode:
        """Boot a fresh empty node wired to see only itself (it learns the
        real topology from the resize instruction)."""
        i = self._next_i
        self._next_i += 1
        cn = PortNode(i, f"{self._tmp}/node{i}", self._backend_factory)
        cn.node.is_coordinator = False
        self._wire(cn, [cn.node])
        self.nodes.append(cn)
        return cn

    def add_node_via_resize(self, timeout: float = 10.0) -> PortNode:
        cn = self.spawn_node()
        self.nodes[0].cluster.resizer.add_node(Node(cn.node.id, cn.node.uri, False))
        await_topology(self.nodes, len(self.nodes), timeout)
        return cn

    def sync_all(self) -> int:
        """One synchronous anti-entropy pass on every node."""
        from pilosa_tpu_torch.cluster.sync import HolderSyncer

        repaired = 0
        for cn in self.nodes:
            syncer = HolderSyncer(cn.cluster)
            repaired += syncer.sync_holder()
            syncer._sync_translation()
        return repaired

    def __getitem__(self, i: int) -> PortNode:
        return self.nodes[i]

    def __len__(self) -> int:
        return len(self.nodes)

    def create_index(self, name: str, options=None) -> None:
        self.nodes[0].api.create_index(name, options)

    def create_field(self, index: str, field: str, options=None) -> None:
        self.nodes[0].api.create_field(index, field, options)

    def query(self, i: int, index: str, pql: str) -> dict:
        return self.nodes[i].api.query(index, pql)

    def await_shard_convergence(self, index: str, timeout: float = 5.0) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            sets = []
            for cn in self.nodes:
                idx = cn.holder.index(index)
                sets.append(tuple(idx.available_shards().to_array().tolist()) if idx else ())
            if len(set(sets)) == 1:
                return
            time.sleep(0.02)
        raise TimeoutError(f"shards never converged: {sets}")

    def close(self) -> None:
        for cn in self.nodes:
            try:
                cn.close()
            except Exception:
                pass
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "PortCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def await_topology(nodes, n, timeout=10.0):
    """Wait until every node sees n members and is NORMAL."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(len(x.cluster.topology.nodes) == n and x.cluster.state() == "NORMAL"
               for x in nodes):
            return
        time.sleep(0.02)
    states = [(x.node.id, x.cluster.state(), len(x.cluster.topology.nodes)) for x in nodes]
    raise TimeoutError(f"resize never converged: {states}")
