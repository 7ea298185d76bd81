"""Cluster topology: URIs, nodes, partitioning, consistent hashing.

Mirrors the reference's placement math exactly (cluster.go:871-959) so a
dataset sharded by this framework lands on the same nodes the reference
would pick: shard -> partition via fnv64a over (index name, big-endian
shard) mod partitionN (default 256), partition -> primary node via
jump-consistent-hash over the ID-sorted node list, replicas on the next
ReplicaN-1 ring positions.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

from pilosa_tpu_torch.native import fnv64a

DEFAULT_PARTITION_N = 256  # reference cluster.go:44

# Cluster states (reference cluster.go:47-50).
STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"

# Node states during resize (reference node.go).
NODE_STATE_READY = "READY"
NODE_STATE_DOWN = "DOWN"

_URI_RE = re.compile(
    r"^(?:(?P<scheme>[a-zA-Z][a-zA-Z0-9+.-]*)://)?(?P<host>[^:/]+)?(?::(?P<port>\d+))?$"
)


@dataclass(frozen=True)
class URI:
    """scheme://host:port node address (reference uri.go)."""

    scheme: str = "http"
    host: str = "localhost"
    port: int = 10101

    @staticmethod
    def parse(s: str) -> "URI":
        m = _URI_RE.match(s.strip())
        if not m:
            raise ValueError(f"invalid URI: {s!r}")
        return URI(
            scheme=m.group("scheme") or "http",
            host=m.group("host") or "localhost",
            port=int(m.group("port") or 10101),
        )

    def __str__(self) -> str:
        return f"{self.scheme}://{self.host}:{self.port}"

    @property
    def host_port(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass
class Node:
    """Cluster member (reference node.go Node)."""

    id: str
    uri: URI
    is_coordinator: bool = False
    state: str = NODE_STATE_READY

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "uri": {
                "scheme": self.uri.scheme,
                "host": self.uri.host,
                "port": self.uri.port,
            },
            "isCoordinator": self.is_coordinator,
            "state": self.state,
        }

    @staticmethod
    def from_json(d: dict) -> "Node":
        u = d.get("uri") or {}
        return Node(
            id=d["id"],
            uri=URI(
                scheme=u.get("scheme", "http"),
                host=u.get("host", "localhost"),
                port=int(u.get("port", 10101)),
            ),
            is_coordinator=bool(d.get("isCoordinator")),
            state=d.get("state", NODE_STATE_READY),
        )


class JmpHasher:
    """Jump consistent hash (reference cluster.go:947-959)."""

    @staticmethod
    def hash(key: int, n: int) -> int:
        key &= (1 << 64) - 1
        b, j = -1, 0
        while j < n:
            b = j
            key = (key * 2862933555777941757 + 1) & ((1 << 64) - 1)
            j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
        return b


class ModHasher:
    """Deterministic key % n hasher for tests (reference test/cluster.go:18)."""

    @staticmethod
    def hash(key: int, n: int) -> int:
        return key % n


class Topology:
    """Pure placement math over an ID-sorted node list.

    Separated from Cluster so resize planning can diff two topologies
    (reference cluster.fragSources cluster.go:784 compares old/new node
    sets through the same partition functions).
    """

    def __init__(
        self,
        nodes: Optional[Sequence[Node]] = None,
        replica_n: int = 1,
        partition_n: int = DEFAULT_PARTITION_N,
        hasher=None,
    ):
        self.nodes: list[Node] = sorted(nodes or [], key=lambda n: n.id)
        self.replica_n = replica_n
        self.partition_n = partition_n
        self.hasher = hasher or JmpHasher()

    # -- membership --------------------------------------------------------

    def add_node(self, node: Node) -> None:
        if self.node_by_id(node.id) is None:
            self.nodes.append(node)
            self.nodes.sort(key=lambda n: n.id)

    def remove_node(self, node_id: str) -> bool:
        n = self.node_by_id(node_id)
        if n is None:
            return False
        self.nodes.remove(n)
        return True

    def node_by_id(self, node_id: str) -> Optional[Node]:
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None

    # -- placement (reference cluster.go:871-959) --------------------------

    def partition(self, index: str, shard: int) -> int:
        buf = index.encode() + shard.to_bytes(8, "big")
        return fnv64a(buf) % self.partition_n

    def partition_nodes(self, partition_id: int) -> list[Node]:
        if not self.nodes:
            return []
        replica_n = min(max(self.replica_n, 1), len(self.nodes))
        node_index = self.hasher.hash(partition_id, len(self.nodes))
        return [self.nodes[(node_index + i) % len(self.nodes)] for i in range(replica_n)]

    def shard_nodes(self, index: str, shard: int) -> list[Node]:
        return self.partition_nodes(self.partition(index, shard))

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def primary_for_shard(self, index: str, shard: int) -> Optional[Node]:
        nodes = self.shard_nodes(index, shard)
        return nodes[0] if nodes else None

    def contains_shards(self, index: str, shards: Sequence[int], node: Node) -> list[int]:
        """Shards owned by node incl. replicas (reference containsShards :926)."""
        out = []
        for s in shards:
            if any(n.id == node.id for n in self.shard_nodes(index, s)):
                out.append(s)
        return out


# ---------------------------------------------------------------------------
# persisted topology
# ---------------------------------------------------------------------------

#: File name under the data dir; the reference persists .topology the
#: same way (topology.go encode/decode via holder.loadTopology).
TOPOLOGY_FILE = ".topology"


def save_topology(path: str, topology: Topology, local_id: str,
                  resize_epoch: int = 0) -> None:
    """Atomically persist membership (nodes, replicaN, partitionN) plus
    this node's identity and the resize epoch. tmp + os.replace: a crash
    mid-write leaves either the old complete file or the new complete
    file, never a torn prefix (the PR 8 durable-write discipline — the
    lint rule covers this package)."""
    import json
    import os

    blob = json.dumps(
        {
            "localID": local_id,
            "replicaN": topology.replica_n,
            "partitionN": topology.partition_n,
            "resizeEpoch": int(resize_epoch),
            "nodes": [n.to_json() for n in topology.nodes],
        }
    )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(blob + "\n")
    os.replace(tmp, path)


def load_topology(path: str) -> Optional[dict]:
    """The persisted topology dict, or None when the file is absent,
    unparseable, or structurally invalid (a corrupt topology file must
    degrade to 'seed me again', never crash the boot — the operator's
    config still works). Every node entry must round-trip through
    Node.from_json, so callers can construct Nodes without guarding."""
    import json

    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict) or not isinstance(d.get("nodes"), list):
        return None
    try:
        for entry in d["nodes"]:
            Node.from_json(entry)
    except (TypeError, KeyError, ValueError, AttributeError):
        return None  # truncated / hand-mangled node entries
    return d
