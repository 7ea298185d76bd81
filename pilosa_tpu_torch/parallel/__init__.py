"""One node over several devices: the shard mesh (parallel/mesh.py).

The JAX package places a node's stacks over a jax device mesh and runs
its programs under shard_map with psum reductions. The port does the same
in one process over a list of torch devices: every stack is cut into one
part a device, a program runs its kernel on each part, and the parts'
partial results are summed or gathered on the first device. Across nodes
the cluster layer (pilosa_tpu_torch/cluster) serves, as in the reference.
"""

from pilosa_tpu_torch.parallel.mesh import (
    MeshConfigError,
    ShardMesh,
    Sharded,
    pad_to_multiple,
)
