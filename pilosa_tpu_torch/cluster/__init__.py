"""Cluster layer: topology, peer RPC, scatter-gather, resize, anti-entropy.

The reference's distribution model (SURVEY.md §2.2): the column space is
cut into 2^20-wide shards, shards hash to one of 256 partitions
(fnv64a(index, shard) % 256, reference cluster.go:871), partitions map to
a ring offset via jump-consistent-hash (cluster.go:947), and ReplicaN
consecutive ring nodes own each partition. Queries scatter shards to
owning nodes and stream-reduce; writes fan out to every replica.

This package is the plane across hosts. Cluster.attach installs the
executor's mapper and router seams; cluster.sync keeps replicas converged
(key translation, anti-entropy, failure detection), cluster.resize moves
shards when a node joins or leaves, and cluster.consistency repairs the
replica divergence that hedged reads witness. Each node answers its own
legs on its device backend: a node's card holds the stacks of the shards
it serves.
"""

from pilosa_tpu_torch.cluster.topology import (
    URI,
    Node,
    Topology,
    JmpHasher,
    ModHasher,
    STATE_STARTING,
    STATE_NORMAL,
    STATE_DEGRADED,
    STATE_RESIZING,
)
from pilosa_tpu_torch.cluster.cluster import Cluster
from pilosa_tpu_torch.cluster.client import InternalClient, ClientError
from pilosa_tpu_torch.cluster.broadcast import (
    Message,
    NopBroadcaster,
    HTTPBroadcaster,
)

__all__ = [
    "URI",
    "Node",
    "Topology",
    "JmpHasher",
    "ModHasher",
    "Cluster",
    "InternalClient",
    "ClientError",
    "Message",
    "NopBroadcaster",
    "HTTPBroadcaster",
    "STATE_STARTING",
    "STATE_NORMAL",
    "STATE_DEGRADED",
    "STATE_RESIZING",
]
