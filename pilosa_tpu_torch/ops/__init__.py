"""Device ops: the dense shard-stack layout (blocks) and the hand-written
CUDA popcount kernels with their plain PyTorch versions (kernels, build)."""
