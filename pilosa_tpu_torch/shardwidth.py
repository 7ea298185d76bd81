"""Shard width configuration.

The column space is cut into fixed-width shards. The reference selects the
width at compile time via build tags (reference shardwidth/20.go:19, variants
16..32); here it is a module constant overridable with the PILOSA_TPU_SHARD_WIDTH
environment variable (set before first import; tests use 20 like the reference
default, Makefile:9).

One shard row is SHARD_WIDTH bits = SHARD_WIDTH/2^16 roaring containers
(reference fragment.go:55-66). On device a shard row is SHARD_WIDTH/32 uint32
words (dense block layout, see pilosa_tpu_torch/ops/blocks.py).
"""

import os

SHARD_WIDTH_EXP = int(os.environ.get("PILOSA_TPU_SHARD_WIDTH", "20"))
if not 16 <= SHARD_WIDTH_EXP <= 32:
    raise ValueError(f"shard width exponent out of range: {SHARD_WIDTH_EXP}")

SHARD_WIDTH = 1 << SHARD_WIDTH_EXP

# Number of 2^16-bit roaring containers per shard row (reference fragment.go:63).
ROW_SEGMENT_CONTAINERS = SHARD_WIDTH >> 16
