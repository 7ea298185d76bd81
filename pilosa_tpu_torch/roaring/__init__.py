"""64-bit Roaring bitmaps, numpy-vectorized.

Re-design of the reference's roaring package (reference roaring/roaring.go):
a Bitmap maps 48-bit container keys to 2^16-bit containers. In memory a
container is either a sorted uint16 array or a 1024-word uint64 bitmap —
run containers exist only in the serialized form (they are converted on read
and re-detected by Optimize-equivalent logic on write, mirroring the effect of
reference roaring/roaring.go Optimize). All container ops are vectorized
numpy; the hot query path does not run per-bit Python loops.

The serialized form is byte-compatible with the reference's Pilosa roaring
file format (magic 12348, reference roaring/roaring.go:30-45,
docs/architecture.md) including the appended op log, so data directories
written by the Go reference load here and vice versa.
"""

from pilosa_tpu_torch.roaring.bitmap import (
    ARRAY_MAX_SIZE,
    BITMAP_N,
    CONTAINER_WIDTH,
    Bitmap,
    Container,
)
from pilosa_tpu_torch.roaring.codec import (
    MAGIC_NUMBER,
    deserialize,
    serialize,
    serialized_size,
)
