"""The chunked cold build: a stack streamed to the card chunk by chunk, each
chunk on the cheapest wire (the JAX package's ops/sparse.py).

A full build of a stack of at least MIN_CHUNKED_WORDS words
(exec/cuda.py _StackedBlocks.get) feeds ChunkedStackBuilder shard by shard.
The builder stages one CHUNK_WORDS chunk at a time on the host and ships it
on the first of these wires that applies, the reference's tier rule:

  nothing:    an all-zero chunk; the stack starts as torch.zeros.
  container:  the chunk's roaring array and run containers as their own u16
              positions and u16 (start, last) spans, plus a word mask and
              the nonzero words for its bitmap containers and dense feeds.
              Taken when the reference's wire size for it (its page
              geometry, _reference_container_wire) undercuts the raw words
              and the remainder fits a value bucket. The host never
              scatters those containers into dense words.
  words:      a mask of the nonzero words and the words themselves, when at
              most CHUNK_WORDS // 4 words are nonzero (pick_bucket).
  raw:        the chunk's words.

On the card each chunk's wire goes into a pinned host buffer, is copied
with non_blocking=True on the current stream of the stack's device (the
stream the readers use, so the stack is ready for them in stream order),
and is expanded by hand-written kernels straight into the stack's words:
K12 expand_positions, K13 expand_runs and K14 expand_words
(ops/kernels.py, ops/csrc/expand.cu); raw words are copied into place. The
stack is allocated once, zeroed; no chunk accumulator, placement or final
program exists. On the CPU the kernels' plain forms write the same words
and nothing is copied.

What the reference needed and the port does not: the XLA programs compile
one program per shape, so the reference pads values to a bucket menu and
positions and spans to fixed pages, caches its compiled programs, warms
them in the background and ships dense while they are cold (its
``*_not_warm_total`` and ``stack_sparse_warm_failures_total`` counters).
K12 to K14 take their lengths at run time, so nothing is padded and nothing
warms but the kernel libraries' load, which ``preheat`` already does
(exec/cuda.py CUDABackend._preheat_programs); those counters have nothing
to count and are not published. The reference's page geometry survives
only in the tier decision, so the port picks the reference's tier for
every chunk.

The in-flight bound: MAX_PENDING_BYTES bounds the wire that has been
copied but not yet expanded, as the reference bounds its queue. Each chunk
in flight holds its pinned staging buffer; past the bound the builder
takes back the oldest chunk's buffer, waiting on its CUDA event if the
card has not finished with it (stack_pending_drains_total counts these,
the builder's wait_seconds their cost). Pinned buffers come from one pool
for the process in power-of-two sizes (cudaHostAlloc of tens of MiB costs
milliseconds), each handed to one builder at a time with the event of its
last copy, which the next user waits on before writing it. The card holds
one staging buffer a builder: its copies and kernels run in stream order,
so a chunk's copy cannot overwrite the wire of one not yet expanded. A
build's transient device memory is the stack plus that buffer.

Counters, the reference's names: stack_sparse_uploads_total,
stack_sparse_wire_bytes_total (the bytes actually shipped),
stack_sparse_dense_bytes_total (a dense chunk's bytes for every chunk),
stack_container_chunks_total, stack_container_pos_total,
stack_container_runs_total, stack_container_wire_bytes_total and
stack_pending_drains_total.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional

import numpy as np
import torch

from pilosa_tpu_torch import native
from pilosa_tpu_torch.ops import kernels as K
from pilosa_tpu_torch.ops.blocks import (
    WORDS_PER_SHARD,
    _CONTAINERS_PER_ROW,
    _WORDS_PER_CONTAINER,
    pack_fragment,
)
from pilosa_tpu_torch.roaring.bitmap import _runs_to_bitmap_words
from pilosa_tpu_torch.utils.stats import global_stats

#: Chunk size in uint32 words (32 MiB dense). Read at call time, like the
#: constants below, so that tests can shrink it.
CHUNK_WORDS = 1 << 23

#: Stacks below this many words are packed dense and copied whole.
MIN_CHUNKED_WORDS = 2 * CHUNK_WORDS

#: Off: every chunk takes the word tiers (the dense baseline of a cold
#: build, in the same process).
CONTAINER_TIER_ENABLED = True

#: The wire that may be copied but not yet expanded, in bytes.
MAX_PENDING_BYTES = 256 << 20


def _n_slots() -> int:
    """Roaring-container slots per chunk (container = 2048 words)."""
    return CHUNK_WORDS // _WORDS_PER_CONTAINER


def _pos_page() -> int:
    """The reference's array-container positions per expansion page."""
    return max(1024, CHUNK_WORDS // 8)


def _run_page() -> int:
    """The reference's run-container spans per expansion page."""
    return max(256, CHUNK_WORDS // 128)


def compress_chunk(chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(mask u32[C/32], vals u32[nnz], nnz) for one CHUNK_WORDS chunk.
    Bit b of mask[j] marks chunk[j*32+b] nonzero; vals are the nonzero
    words in order. Native C++ with a numpy fallback."""
    mask = np.empty(CHUNK_WORDS // 32, dtype=np.uint32)
    vals_cap = np.empty(CHUNK_WORDS, dtype=np.uint32)
    nnz = native.compress_words(chunk, mask, vals_cap)
    if nnz is None:
        nz = chunk != 0
        np.bitwise_or.reduce(
            nz.reshape(-1, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)[None, :],
            axis=1, out=mask,
        )
        vals = chunk[nz]
        return mask, vals, int(vals.size)
    return mask, vals_cap[:nnz], nnz


def pick_bucket(nnz: int) -> Optional[int]:
    """The reference's value bucket for nnz nonzero words, None past
    CHUNK_WORDS // 4: the words tier applies only where it returns one."""
    for b in (CHUNK_WORDS // 32, CHUNK_WORDS // 16, CHUNK_WORDS // 8, CHUNK_WORDS // 4):
        if nnz <= b:
            return b
    return None


def _reference_container_wire(npos: int, nruns: int, rem_wire: int) -> int:
    """The reference's container-chunk wire (sparse.py:618-627): positions
    and runs in whole pages, each position page with its slot counts."""
    pp, rp = _pos_page(), _run_page()
    return (((npos + pp - 1) // pp) * (pp * 2 + _n_slots() * 4)
            + ((nruns + rp - 1) // rp) * (rp * 8) + rem_wire)


# ---------------------------------------------------------------------------
# pinned staging buffers, one pool for the process
# ---------------------------------------------------------------------------

_POOL_LOCK = threading.Lock()
# (bytes, pinned) -> [(uint8 tensor, event of its last copy or None)]
_POOL: dict = {}
#: Free buffers the pool keeps for each size; more are freed.
POOL_KEEP = 16
#: The smallest staging buffer, in bytes.
MIN_BUFFER_BYTES = 1 << 16


def _take_buffer(nbytes: int, pinned: bool) -> torch.Tensor:
    """A buffer of at least nbytes (a power of two): a free one of the pool,
    once the copy that last read it is done, or a new one."""
    size = max(MIN_BUFFER_BYTES, 1 << max(0, nbytes - 1).bit_length())
    with _POOL_LOCK:
        free = _POOL.get((size, pinned))
        buf, event = free.pop() if free else (None, None)
    if buf is None:
        return torch.empty(size, dtype=torch.uint8, pin_memory=pinned)
    if event is not None:
        event.synchronize()
    return buf


def _give_buffer(buf: torch.Tensor, pinned: bool, event) -> None:
    with _POOL_LOCK:
        free = _POOL.setdefault((buf.numel(), pinned), [])
        if len(free) < POOL_KEEP:
            free.append((buf, event))


class _Layout:
    """One chunk's wire: 16-byte aligned segments of (count, dtype) in one
    staging buffer. The host writes each through a numpy view (arrays),
    the kernels read it through a typed view of the same bytes (views)."""

    def __init__(self, specs, pinned: bool):
        self.segments = []
        used = 0
        for n, dtype in specs:
            start = (used + 15) & ~15
            used = start + n * np.dtype(dtype).itemsize
            self.segments.append((start, used, dtype))
        self.used = used
        self.host = _take_buffer(used, pinned)
        host_np = self.host.numpy()
        self.arrays = [host_np[a:b].view(dt) for a, b, dt in self.segments]

    def views(self, src: torch.Tensor) -> list:
        """Each segment of `src` (the buffer, or its copy on the card) as
        the int32 or int16 tensor the kernels take."""
        return [src[a:b].view(torch.int16 if np.dtype(dt).itemsize == 2 else torch.int32)
                for a, b, dt in self.segments]


def _copy_raw(out, views) -> None:
    (words,) = views
    out.copy_(words, non_blocking=True)


def _expand_containers(out, views) -> None:
    a_slot, a_start, r_slot, r_start, pos, spans, *rem = views
    if a_slot.numel():
        K.expand_positions(out, pos, a_slot, a_start)
    if r_slot.numel():
        K.expand_runs(out, spans, r_slot, r_start)
    if rem:
        K.expand_words(out, *rem)


# What each tier does with its wire's views on the stack's chunk.
_EXPAND = {
    "raw": _copy_raw,
    "words": lambda out, views: K.expand_words(out, *views),
    "container": _expand_containers,
}


def _words_specs(mask, vals) -> list:
    """The words tier's segments, K14's arguments in its order: the mask,
    the values, the block bases."""
    return [(mask.size, np.uint32), (vals.size, np.uint32),
            (-(-mask.size // K.EXPAND_WORDS_BLOCK), np.int32)]


def _stage_words(arrays, mask, vals) -> None:
    arrays[0][:] = mask
    arrays[1][:] = vals
    arrays[2][:] = K.expand_words_bases(mask)


class ChunkedStackBuilder:
    """Streaming builder of one stack on `device`: the caller feeds the
    stack's words in order (shard slab granularity), dense through feed(),
    known-zero regions through skip() and whole fragments container-native
    through feed_fragment(), and finish() returns the int32[shape] stack.
    Each chunk ships as it fills, so its copy and expansion run under the
    next chunk's host pack.

    timed=True (on the card) records CUDA events around each chunk's copy
    and expansion for split()."""

    def __init__(self, device, shape: tuple, timed: bool = False):
        self.device = torch.device(device)
        self.shape = tuple(int(s) for s in shape)
        self.n = int(np.prod(self.shape))
        self.stack = torch.zeros(self.shape, dtype=torch.int32, device=self.device)
        self._flat = self.stack.view(-1)
        self._cuda = self.device.type == "cuda"
        self._chunk = CHUNK_WORDS
        self._stage = np.zeros(self._chunk, dtype=np.uint32)
        # True when the current chunk's stage holds any fed words (the
        # container path skips the stage, so a clean stage never pays the
        # compress scan or a re-zero).
        self._stage_dirty = False
        self._fill = 0
        self._offset = 0
        self._wire_bytes = 0
        self._dense_bytes = 0
        # Roaring containers of the current chunk: (slot, data), the
        # container's own u16 positions or u16 [R, 2] runs, by reference.
        self._chunk_arrays: list = []
        self._chunk_runs: list = []
        # Chunks shipped by tier (the reference's kinds: "container",
        # "words" for its "sparse", "raw" for its "dense"; "empty" shipped
        # nothing).
        self.chunks = {"empty": 0, "words": 0, "container": 0, "raw": 0}
        # (event or None, wire bytes, buffer) of each chunk in flight.
        self._inflight: collections.deque = collections.deque()
        self._pending_bytes = 0
        self._dev_buf = None
        self._timed = timed and self._cuda
        self._events: list = []
        self.host_seconds = 0.0
        self.wait_seconds = 0.0

    # -- feeding ---------------------------------------------------------

    def feed(self, words: np.ndarray) -> None:
        """Append a flat uint32 slab (any length)."""
        t0 = time.perf_counter()
        pos = 0
        n = words.size
        while pos < n:
            take = min(self._chunk - self._fill, n - pos)
            self._stage[self._fill : self._fill + take] = words[pos : pos + take]
            self._stage_dirty = True
            self._fill += take
            pos += take
            if self._fill == self._chunk:
                self._flush()
        self.host_seconds += time.perf_counter() - t0

    def skip(self, n_words: int) -> None:
        """Advance over a known-all-zero region (a missing fragment) without
        staging a byte."""
        t0 = time.perf_counter()
        self._advance(self._offset + self._fill + int(n_words))
        self.host_seconds += time.perf_counter() - t0

    def _advance(self, target: int) -> None:
        """Move the write position forward to `target`, flushing the full
        chunks crossed on the way."""
        while target >= self._offset + self._chunk:
            self._fill = self._chunk
            self._flush()
        self._fill = target - self._offset

    def feed_fragment(self, frag, n_rows: int) -> None:
        """Stream one fragment's slab container-natively: array and run
        containers are recorded for the container tier, bitmap containers
        are copied into the stage, gaps advance. Advances exactly n_rows *
        WORDS_PER_SHARD words, like feeding pack_fragment(frag, n_rows).
        Feeds the dense pack when the tier is off or the geometry cannot
        carry containers (chunks of part of a container, an unaligned
        base)."""
        base = self._offset + self._fill
        if (
            not CONTAINER_TIER_ENABLED
            or self._chunk % _WORDS_PER_CONTAINER
            or base % _WORDS_PER_CONTAINER
        ):
            self.feed(pack_fragment(frag, n_rows=n_rows).reshape(-1))
            return
        t0 = time.perf_counter()
        storage = frag.storage
        for key in storage.keys():
            c = storage.container(key)
            if c is None or c.n == 0:
                continue
            row = key // _CONTAINERS_PER_ROW
            if row >= n_rows:
                continue  # caller asked for fewer rows than stored
            gw = base + row * WORDS_PER_SHARD + (
                key % _CONTAINERS_PER_ROW
            ) * _WORDS_PER_CONTAINER
            self._advance(gw)
            slot = self._fill // _WORDS_PER_CONTAINER
            if c.typ == "array":
                self._chunk_arrays.append((slot, c.data))
            elif c.typ == "run":
                self._chunk_runs.append((slot, c.data))
            else:  # bitmap container: already dense, copied to the stage
                self._stage[
                    self._fill : self._fill + _WORDS_PER_CONTAINER
                ] = c.data.view("<u4")
                self._stage_dirty = True
            self._advance(gw + _WORDS_PER_CONTAINER)
        self._advance(base + n_rows * WORDS_PER_SHARD)
        self.host_seconds += time.perf_counter() - t0

    # -- the tiers -------------------------------------------------------

    def _flush(self) -> None:
        if self._fill == 0 and not self._chunk_arrays and not self._chunk_runs:
            return
        self._dense_bytes += self._chunk * 4
        if self._chunk_arrays or self._chunk_runs:
            self._flush_container_chunk()
        elif self._stage_dirty:
            self._flush_dense_chunk()
        else:
            self.chunks["empty"] += 1
        self._offset += self._chunk
        self._fill = 0
        if self._stage_dirty:
            self._stage[:] = 0
            self._stage_dirty = False
        self._chunk_arrays = []
        self._chunk_runs = []

    def _valid(self) -> int:
        """Words of the current chunk inside the stack (the last chunk may
        be short)."""
        return min(self._chunk, self.n - self._offset)

    def _flush_dense_chunk(self) -> None:
        """The word-granular tiers over the staged chunk: nothing, the
        words tier, or the raw words."""
        mask, vals, nnz = compress_chunk(self._stage)
        if nnz == 0:
            self.chunks["empty"] += 1
            return
        if pick_bucket(nnz) is None:
            self.chunks["raw"] += 1
            valid = self._valid()
            lay = _Layout([(valid, np.uint32)], self._cuda)
            lay.arrays[0][:] = self._stage[:valid]
            self._ship(lay, "raw")
        else:
            self.chunks["words"] += 1
            lay = _Layout(_words_specs(mask, vals), self._cuda)
            _stage_words(lay.arrays, mask, vals)
            self._ship(lay, "words")

    def _flush_container_chunk(self) -> None:
        """The container tier, taken when the reference's wire size for it
        undercuts the raw words; bitmap containers and dense feeds in the
        same chunk ride a word-mask remainder."""
        npos = int(sum(d.size for _, d in self._chunk_arrays))
        nruns = int(sum(d.shape[0] for _, d in self._chunk_runs))
        rem = None
        rem_wire = 0
        if self._stage_dirty:
            mask, vals, nnz_rem = compress_chunk(self._stage)
            if nnz_rem:
                bucket = pick_bucket(nnz_rem)
                if bucket is None:
                    # The remainder alone is dense: let the word tiers
                    # decide over the whole chunk.
                    self._materialize_dense()
                    return
                rem = (mask, vals)
                rem_wire = mask.nbytes + bucket * 4
        if _reference_container_wire(npos, nruns, rem_wire) >= self._chunk * 4:
            self._materialize_dense()
            return
        self.chunks["container"] += 1
        arrays, runs = self._chunk_arrays, self._chunk_runs
        lay = _Layout([(len(arrays), np.int32), (len(arrays) + 1, np.int32),
                       (len(runs), np.int32), (len(runs) + 1, np.int32),
                       (npos, np.uint16), (2 * nruns, np.uint16)]
                      + (_words_specs(*rem) if rem is not None else []), self._cuda)
        a_slot, a_start, r_slot, r_start, pos, spans = lay.arrays[:6]
        for slots, starts, entries, sizes in (
            (a_slot, a_start, arrays, [d.size for _, d in arrays]),
            (r_slot, r_start, runs, [d.shape[0] for _, d in runs]),
        ):
            slots[:] = [s for s, _ in entries]
            starts[0] = 0
            np.cumsum(sizes, out=starts[1:])
        if npos:
            np.concatenate([d for _, d in arrays], out=pos, casting="unsafe")
        if nruns:
            np.concatenate([d.reshape(-1) for _, d in runs], out=spans, casting="unsafe")
        if rem is not None:
            _stage_words(lay.arrays[6:], *rem)
        self._ship(lay, "container")
        global_stats.count("stack_container_chunks_total")
        global_stats.count("stack_container_pos_total", npos)
        global_stats.count("stack_container_runs_total", nruns)
        global_stats.count("stack_container_wire_bytes_total", lay.used)

    def _materialize_dense(self) -> None:
        """Container-tier fallback: scatter the recorded containers into
        the stage (what pack_fragment would have done) and let the word
        tiers ship the chunk."""
        for slot, data in self._chunk_arrays:
            base = slot * _WORDS_PER_CONTAINER
            d = np.ascontiguousarray(data, dtype=np.uint16)
            if not native.scatter_positions(self._stage, base, d):
                pos = d.astype(np.uint32)
                np.bitwise_or.at(
                    self._stage,
                    base + (pos >> 5),
                    np.uint32(1) << (pos & np.uint32(31)),
                )
        for slot, runs in self._chunk_runs:
            base = slot * _WORDS_PER_CONTAINER
            self._stage[base : base + _WORDS_PER_CONTAINER] |= (
                _runs_to_bitmap_words(runs).view("<u4")
            )
        self._stage_dirty = True
        self._flush_dense_chunk()

    # -- shipping --------------------------------------------------------

    def _wait_oldest(self) -> None:
        """Take back the oldest in-flight chunk's buffer for the pool,
        waiting on its event if the card has not finished with it."""
        event, nbytes, buf = self._inflight.popleft()
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            self.wait_seconds += time.perf_counter() - t0
        self._pending_bytes -= nbytes
        _give_buffer(buf, self._cuda, None)
        global_stats.count("stack_pending_drains_total")

    def _ship(self, lay: _Layout, kind: str) -> None:
        """Copy the chunk's wire to the card (the CPU reads it in place) and
        expand it into the stack on the current stream: raw words are
        copied into place, the other tiers' wire into the staging buffer
        for their kernels."""
        out = self._flat[self._offset : self._offset + self._valid()]
        event = None
        if not self._cuda:
            _EXPAND[kind](out, lay.views(lay.host))
        else:
            if kind != "raw" and (self._dev_buf is None or self._dev_buf.numel() < lay.used):
                self._dev_buf = torch.empty(lay.host.numel(), dtype=torch.uint8,
                                            device=self.device)
            stream = torch.cuda.current_stream(self.device)
            marks = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
                     if self._timed else None)
            if marks:
                marks[0].record(stream)
            if kind == "raw":
                _EXPAND[kind](out, lay.views(lay.host))
            else:
                self._dev_buf[: lay.used].copy_(lay.host[: lay.used], non_blocking=True)
            if marks:
                marks[1].record(stream)
            if kind != "raw":
                _EXPAND[kind](out, lay.views(self._dev_buf))
            if marks:
                marks[2].record(stream)
                self._events.append(marks)
            event = torch.cuda.Event()
            event.record(stream)
        self._wire_bytes += lay.used
        self._inflight.append((event, lay.used, lay.host))
        self._pending_bytes += lay.used
        while self._pending_bytes > MAX_PENDING_BYTES:
            self._wait_oldest()

    def finish(self) -> torch.Tensor:
        t0 = time.perf_counter()
        self._flush()
        # Every buffer goes back to the pool with the event of its last
        # copy: the next user waits on it, this builder does not.
        for event, _, buf in self._inflight:
            _give_buffer(buf, self._cuda, event)
        self._inflight.clear()
        self._dev_buf = None
        global_stats.count("stack_sparse_uploads_total")
        global_stats.count("stack_sparse_wire_bytes_total", self._wire_bytes)
        global_stats.count("stack_sparse_dense_bytes_total", self._dense_bytes)
        self.host_seconds += time.perf_counter() - t0
        return self.stack

    def split(self) -> dict:
        """The build's host pack seconds (the host's time in the builder
        less its waits on in-flight chunks), its waits, and, for a timed
        build on the card, the device ms of the copies (raw words into the
        stack, the other tiers' wire into the staging buffer) and of the
        expansions (K12 to K14), summed over chunks. Waits for the card."""
        out = {"host_pack_s": self.host_seconds - self.wait_seconds,
               "wait_s": self.wait_seconds}
        if self._events:
            self._events[-1][2].synchronize()
            out["copy_ms"] = sum(a.elapsed_time(b) for a, b, _ in self._events)
            out["expand_ms"] = sum(b.elapsed_time(c) for _, b, c in self._events)
        return out
