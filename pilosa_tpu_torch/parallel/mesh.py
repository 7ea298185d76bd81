"""The shard mesh: one process's stacks cut over a list of devices.

The JAX package's mesh is a single controller over its devices: a stack is
placed with ``NamedSharding(P('shards'))``, each program runs on every
device's own shards under ``shard_map``, and the partial results meet in
``lax.psum`` (pilosa_tpu/parallel/mesh.py). The port keeps that model in
one process, with no process group:

- a ShardMesh is a list of ``torch.device``s; the same device may appear
  more than once (torch has one CPU device, a one-card machine one card),
  which places several parts on it;
- a sharded tensor (Sharded) is a list of parts, one a device in mesh
  order, each holding a contiguous run of the shard axis; the axis is
  padded with all-zero slabs to a multiple of the device count;
- a program runs its kernel once on each part, on that part's device
  (exec/cuda.py CUDABackend._run), and its partial results are either
  summed in int64 on the mesh's first device (the psum) or concatenated in
  shard order there with the padding cut (the gather).

Padding contract, as in the JAX package: zero slabs are inert everywhere
the backend reduces (a zero word adds nothing to a popcount, a bitwise
verb, a BSI plane walk or a pair or group cell), so padded positions never
change an answer, and per-shard outputs stop at the real shard count.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class MeshConfigError(ValueError):
    """A ShardMesh cannot be built from the given devices (an empty list,
    e.g. a mesh-devices count past the visible cards)."""


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n: the shard-axis padding rule
    that ShardMesh.put and exec/cuda.py _StackedBlocks share."""
    if m <= 1:
        return n
    return ((n + m - 1) // m) * m


class Sharded:
    """A tensor whose shard axis (``axis``, the leading one for a stack) is
    cut into one contiguous part per mesh device, in shard order. ``shape``
    is the whole padded shape, as a sharded array's is in the JAX package;
    ``real`` is the shard count before padding, where a gather cuts."""

    __slots__ = ("parts", "shape", "real", "axis")

    def __init__(self, parts: Sequence[torch.Tensor], real: Optional[int] = None,
                 axis: int = 0):
        self.parts = list(parts)
        self.axis = axis
        shape = list(self.parts[0].shape)
        shape[axis] = sum(int(p.shape[axis]) for p in self.parts)
        self.shape = torch.Size(shape)
        self.real = shape[axis] if real is None else int(real)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The first part's device: where a psum or a gather lands."""
        return self.parts[0].device

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.parts)

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def part_bytes(self) -> list:
        return [p.nbytes for p in self.parts]

    def gather(self) -> torch.Tensor:
        """The parts concatenated on the first part's device, cut at the
        real shard count. A copy from another card is a blocking copy,
        ordered after the work enqueued on that card's current stream."""
        dev = self.device
        out = torch.cat([p.to(dev) for p in self.parts], dim=self.axis)
        return out if out.shape[self.axis] == self.real else out.narrow(self.axis, 0, self.real)

    def narrow(self, dim: int, start: int, length: int) -> torch.Tensor:
        """Shards [start, start + length) of the axis, which must lie in one
        part: a view of that part, on its device."""
        if dim != 0 or self.axis != 0:
            raise ValueError("Sharded.narrow: only a stack's shard axis (dim 0)")
        base = 0
        for p in self.parts:
            n = int(p.shape[0])
            if start < base + n:
                if start + length > base + n:
                    raise ValueError(
                        f"Sharded.narrow: shards [{start}, {start + length}) cross a part")
                return p.narrow(0, start - base, length)
            base += n
        raise IndexError(f"Sharded.narrow: shard {start} past the axis of {base}")


def _pin(device) -> torch.device:
    """A device with its index: "cuda" names the current card, so every
    part and launch names one device whatever thread runs it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class ShardMesh:
    """A 1-D mesh over ``devices``. n is the number of parts a stack is cut
    into; the devices need not be distinct."""

    def __init__(self, devices: Sequence):
        devices = [_pin(d) for d in devices]
        if not devices:
            raise MeshConfigError(
                "ShardMesh needs at least one device (got an empty device "
                "list; check mesh-devices against the visible cards)"
            )
        types = {d.type for d in devices}
        if len(types) != 1:
            raise MeshConfigError(f"ShardMesh devices mix types: {sorted(types)}")
        self.devices = devices
        self.n = len(devices)

    def put(self, host: np.ndarray) -> Sharded:
        """Place a [n_shards, ...] host array over the mesh: pad the
        leading axis with zero slabs to a multiple of n and copy part d,
        the shards [d * s / n, (d + 1) * s / n) of the padded axis, to
        device d. uint32 words become int32 with the same bits, as the
        backend's stacks hold them."""
        host = torch.from_numpy(host.view(np.int32) if host.dtype == np.uint32 else host)
        s = int(host.shape[0])
        s_pad = pad_to_multiple(s, self.n)
        if s_pad != s:
            padded = torch.zeros((s_pad, *host.shape[1:]), dtype=host.dtype)
            padded[:s] = host
            host = padded
        step = s_pad // self.n
        return Sharded([host[d * step : (d + 1) * step].to(dev)
                        for d, dev in enumerate(self.devices)], real=s)
