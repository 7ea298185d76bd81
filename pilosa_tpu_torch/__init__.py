"""pilosa_tpu_torch — the bitmap index on PyTorch and CUDA (NVIDIA H100).

A port of pilosa_tpu, which stays beside it as the reference: the same
storage hierarchy (holder -> index -> field -> view -> fragment), PQL and
answers, with query execution on device-resident shard stacks through
hand-written CUDA popcount kernels (exec/cuda.py, ops/kernels.py).
"""

__version__ = "0.1.0"

from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, SHARD_WIDTH_EXP
