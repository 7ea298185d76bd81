"""Cluster layer: topology, peer RPC, scatter-gather, resize, anti-entropy.

The reference's distribution model (SURVEY.md §2.2): the column space is
cut into 2^20-wide shards, shards hash to one of 256 partitions
(fnv64a(index, shard) % 256, reference cluster.go:871), partitions map to
a ring offset via jump-consistent-hash (cluster.go:947), and ReplicaN
consecutive ring nodes own each partition. Queries scatter shards to
owning nodes and stream-reduce; writes fan out to every replica.

This package is the plane across hosts. The port serves one node so
far: the server imports these types (ClientError, ShardUnavailableError,
the persisted topology), and multi-node serving, with cluster.sync,
cluster.resize, cluster.consistency and the executor's mapper and router
seams, is still to port (ROADMAP.md, queue 1).
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
