"""CUDA device backend: PQL bitmap calls on device-resident shard stacks.

The counterpart of the JAX package's TPUBackend:

- Per (index, field, view) the backend keeps a stacked int32[S, R_pad, W]
  tensor on the device (the bits of the host's uint32 pack), rebuilt when
  the view's generation moves. A write epoch that dirtied few shards
  re-packs only those shards and splices them into the resident stack in
  place (``index_copy_``).
- A bitmap call tree is compiled into a postfix program over leaf rows
  (ops/kernels.py spec_program) and evaluated by the hand-written kernel
  K11 (spec_eval): the Count's per-shard popcounts, or the call's [S, W]
  slab for ``Row`` and filters, in one launch, for one query slot or for a
  window of them (count_batch_async, row_batch_async). A time range ORs its
  quantum views' rows; a BSI condition (``Row(v > 3)``, ``v >< [a, b]``) is
  first one launch of K10 (ops/kernels.py bsi_compare), which walks the
  field's BSI planes once with the predicate's bits resolved on the host,
  and ``Shift`` moves its child's bits up within each shard: both become
  slab leaves of K11 (``v != null`` is the exists row).
- A request of several Counts over one field pair is planned onto one sweep
  of K1 (pair_stats_pershard), or of K2 (pair_stats) when the per-shard
  table is too big to keep; the host derives every verb from the pair
  matrix and the row counts.
- TopN, Rows and unfiltered 1-field GroupBy read a field's per-row counts
  (K8, row_popcounts), cached on the view's generation.
- The pair, TopN and N-field GroupBy tables keep their per-shard rows on
  the host and absorb a write epoch there, with no launch: point writes
  replay from the fragments' bit-op rings as +-1 deltas, other dirty shards
  re-derive from host-packed slabs (the JAX package's incremental tiers,
  over its freshness plane of per-shard (uid, version) walks). Sum counts
  the BSI planes over the positive and the negative columns (K8 with two
  masks) and the considered columns (K3); Min and Max walk the planes per
  shard (K9, bsi_minmax). The host weights and reduces exactly. Unfiltered,
  Sum absorbs a write epoch from the fragments' value-op rings, and Min and
  Max update their per-shard (value, count) table in O(1), re-deriving a
  shard whose extremum was cleared by the fragment's own host walk.
- GroupBy computes its group-count tensor on the card and enumerates the
  nonzero groups on the host: one field from the TopN rank vector (or K3
  when filtered), two through the pair kernels, three or more through the
  group-tile kernels K4/K5 over the extra fields' live row combinations
  (ops/kernels.py).

Under a byte budget (``max_bytes``), a field whose stack cannot be resident
is paged through the card as the JAX package pages it: a ``Row`` leaf takes
its [S, 1, W] row page (_StackedBlocks.get_row), and TopN, Rows and 1-field
GroupBy stream fixed-height row pages through K8 (_topn_paged_counts).

A call without a device lowering here raises _Unsupported while its tree is
assembled (a time range, ``Not``'s existence stack or a BSI stack over the
byte budget, a BSI depth past MAX_BSI_DEPTH) and is answered on the host,
counted in ``cpu_routed_total{call}``. Kernel failures are not caught: they
raise to the caller.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.field import FIELD_TYPE_INT
from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.timequantum import parse_time, views_by_time_range
from pilosa_tpu_torch.core.view import VIEW_STANDARD, bsi_view_name
from pilosa_tpu_torch.exec.cpu import CPUBackend, NotFoundError, QueryError
from pilosa_tpu_torch.exec.result import FieldRow, GroupCount
from pilosa_tpu_torch.ops import sparse
from pilosa_tpu_torch.ops.build import take_load_seconds
from pilosa_tpu_torch.ops.blocks import (
    ROW_PAD,
    WORDS_PER_SHARD,
    _padded_rows,
    fragment_tier_words,
    pack_fragment,
    pack_row,
    pack_rows,
    unpack_row,
    unpack_slab_columns,
)
from pilosa_tpu_torch.ops.kernels import (  # noqa: F401 (the range helpers are re-exported)
    MAX_GROUP_EXTRAS,
    MAX_GROUP_TILE_SLOTS,
    MAX_PAIR_SHARDS,
    MAX_SPLICE_ENTRIES,
    _between_unsigned,
    _bsi_slabs,
    _eq_slab,
    _gt_unsigned,
    _lt_unsigned,
    bsi_compare,
    bsi_minmax,
    group_tile_stats,
    group_tile_stats_pershard,
    pair_stats,
    pair_stats_pershard,
    popcount_rows,
    row_popcounts,
    spec_eval,
    spec_leaf_rows,
    spec_program,
    splice_slabs,
    split_minmax,
)
from pilosa_tpu_torch.parallel.mesh import Sharded, pad_to_multiple
from pilosa_tpu_torch.pql.ast import (
    BETWEEN, Call, Condition, EQ, GT, GTE, LT, LTE, NEQ, canonical_key,
    is_reserved_arg,
)
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.devtrace import trace_range
from pilosa_tpu_torch.utils.locks import InstrumentedRLock
from pilosa_tpu_torch.utils.qprofile import NOP_PROFILE, current_profile
from pilosa_tpu_torch.utils.reuse import ReuseDistanceEstimator
from pilosa_tpu_torch.utils.stats import global_stats

_DEVICE_LOWERED = ("Row", "Range", "Union", "Intersect", "Difference", "Xor", "Not", "All",
                   "Shift")

# Pair-stats host cache bound: entries may hold in-flight device tables, so
# the LRU cap keeps many-field indexes from pinning device memory.
MAX_PAIR_CACHE_ENTRIES = 16

# Device-memory cap for one batched row launch's [Q, S, W] output: a row
# group whose distinct slots would exceed it splits into several launches
# (the JAX package's MAX_ROW_BATCH_BYTES).
MAX_ROW_BATCH_BYTES = 256 << 20

# Host-side cap on one GroupBy result tensor's cells (live_K * Rf * Rg).
# Bounds the aggregate-cache charge and the enumeration working set;
# combinations past it go to the CPU oracle rather than exhausting the host.
MAX_GROUP_RESULT_CELLS = 1 << 24

# BSI min/max assemble values from per-plane decision bits on the host, and
# sums weight plane counts in exact Python ints, so depth is bounded only by
# the int64 BSI range.
MAX_BSI_DEPTH = 63


class _Unsupported(Exception):
    """Raised by the spec builder when a call can't be device-lowered."""


#: Recorded-version sentinel: equal to no live (uid, version), so the next
#: epoch's diff marks the shard dirty and the delta tier's uid check hands
#: it to the slab tier. Recorded wherever captured content could not be
#: confirmed against a version (a write raced the capture): recording a
#: version OLDER than the content would make the delta replay, which is
#: not idempotent, apply ops twice.
_VERS_STALE = ("stale", -1)


def _locked_version(fr):
    """A fragment's (uid, version) read under fr.lock, None for a missing
    one. Writers mutate storage before they bump the version, inside their
    critical section, so an unlocked read can pair the pre-write version
    with post-write content."""
    if fr is None:
        return None
    with fr.lock:
        return (fr.uid, fr.version)


def _pack_confirmed(fr, n_rows: int):
    """(uint32[n_rows, W] slab, (uid, version)) with the version read under
    fr.lock before and after the pack: a write in between re-packs, so the
    version describes exactly the slab's content."""
    while True:
        v = _locked_version(fr)
        slab = pack_fragment(fr, n_rows=n_rows)
        if _locked_version(fr) == v:
            return slab, v


def _host_slab_pair_flat(fslab: np.ndarray, gslab: np.ndarray) -> np.ndarray:
    """One shard's pair-table row int32[rf*rg + rf + rg] from host-packed
    slabs, K1's row for the same slabs bit for bit: a row the host derives
    sits next to rows K1 swept. The AND is chunked over the word axis so
    the temporary stays near 64 MiB at any rf * rg."""
    rf, w = fslab.shape
    rg = gslab.shape[0]
    chunk = max(1, (64 << 20) // max(1, rf * rg * 4))
    pair = np.zeros((rf, rg), dtype=np.int64)
    for c0 in range(0, w, chunk):
        blk = fslab[:, None, c0 : c0 + chunk] & gslab[None, :, c0 : c0 + chunk]
        pair += np.bitwise_count(blk).sum(axis=-1, dtype=np.int64)
    cf = np.bitwise_count(fslab).sum(axis=-1, dtype=np.int64)
    cg = np.bitwise_count(gslab).sum(axis=-1, dtype=np.int64)
    return np.concatenate([pair.ravel(), cf, cg]).astype(np.int32)


def _host_slab_row_counts(slab: np.ndarray) -> np.ndarray:
    """One shard's per-row popcounts int64[R] from a host-packed slab: its
    row of K8's [S, R] table."""
    return np.bitwise_count(slab).sum(axis=-1, dtype=np.int64)


def _host_slab_groupn(slabs: list, rs: list) -> np.ndarray:
    """One shard's row int32[K*rf*rg] of the N-field group table from
    host-packed slabs (uint32[rs[t], W] a field), K7's row for the same
    slabs bit for bit, and K5's once its tiles are scattered: a row the
    host derives sits next to rows the card swept. Slot k is the odometer
    over the extra fields' rows, the last field fastest, as in the kernels.
    The AND is chunked over the word axis as in _host_slab_pair_flat."""
    rf, rg = rs[0], rs[1]
    extra_rs = rs[2:]
    k_total = _prod(extra_rs)
    fslab, gslab = slabs[0], slabs[1]
    w = fslab.shape[1]
    out = np.empty((k_total, rf, rg), dtype=np.int64)
    chunk = max(1, (64 << 20) // max(1, rf * rg * 4))
    for k in range(k_total):
        m = None
        rem = k
        for t in range(len(extra_rs) - 1, -1, -1):
            row = slabs[2 + t][rem % extra_rs[t]]
            rem //= extra_rs[t]
            m = row if m is None else (m & row)
        fm = fslab & m[None, :]
        pair = np.zeros((rf, rg), dtype=np.int64)
        for c0 in range(0, w, chunk):
            blk = fm[:, None, c0 : c0 + chunk] & gslab[None, :, c0 : c0 + chunk]
            pair += np.bitwise_count(blk).sum(axis=-1, dtype=np.int64)
        out[k] = pair
    return out.reshape(-1).astype(np.int32)


#: Marks the calling thread as the windowed refresher: refresh_stale() sets
#: it around its get() calls, so the freshness counters tell a window's
#: flush (stack_windowed_refresh_total) from a read that refreshed a stale
#: stack inline mid-window (stack_refresh_forced_total).
_REFRESHER = threading.local()


def _count_reuse_samples(n: int) -> None:
    global_stats.count("reuse_distance_samples_total", n)


def _give_staged(held) -> None:
    """Give a splice round's staging buffers ((buffers, pinned, event of
    their copy) or None) back to ops/sparse.py's pool."""
    if held is not None:
        bufs, pinned, event = held
        for buf in bufs:
            sparse._give_buffer(buf, pinned, event)


class _StackedBlocks:
    """Device cache: (index, field, view) -> int32[S, R_pad, W] + freshness.

    An optional byte budget LRU-evicts whole stacks and row pages. A stack
    that can never fit is not cached: its callers page its rows through
    the device (get_row, CUDABackend._topn_paged_counts) or, for the calls
    the JAX package does not page, route to the CPU oracle. Each resident
    entry has an HBM ledger entry (ledger(), tier_bytes(), /debug/hbm), with
    a decayed-frequency heat (heat_snapshot(), /debug/heat), and every
    access, hit or upload, feeds the reuse-distance estimator behind the
    /debug/heat miss-ratio curve.

    With refresh_window_ms > 0 the backend's refresher thread calls
    refresh_stale() every window, so the shards a window's writes dirtied
    are spliced into each resident stack once, off the read path. A read
    that meets a stale stack mid-window still refreshes it inline first,
    so answers are those of unwindowed execution.

    Under a mesh (parallel/mesh.py) the shard axis is padded with zero
    slabs to a multiple of the device count and every stack and row page
    is a Sharded: one part a mesh device, each built, spliced and held on
    its own device."""

    #: Incremental-update cutoff: splice at most 1/2 of the shard axis
    #: before a full repack wins.
    MAX_INCREMENTAL_FRACTION = 2

    #: Decayed-frequency half-life of an entry's heat, in seconds: an entry
    #: untouched for one half-life keeps half its heat.
    HEAT_HALF_LIFE = 300.0

    def __init__(self, device: torch.device, max_bytes: Optional[int] = None,
                 heat_half_life: Optional[float] = None, mesh=None):
        self.device = device
        self.mesh = mesh  # a ShardMesh of n > 1 devices, or None
        self.max_bytes = max_bytes
        self.heat_half_life = heat_half_life or self.HEAT_HALF_LIFE
        # Every ledger access (hit or upload) is offered to the estimator's
        # queue (one append), recorded in bulk; each bulk's admitted samples
        # bump reuse_distance_samples_total.
        self.reuse = ReuseDistanceEstimator(on_samples=_count_reuse_samples)
        # key -> (fingerprint, device tensor, rows_p, per-shard versions).
        self._entries: dict[tuple, tuple[tuple, torch.Tensor, int, Optional[tuple]]] = {}
        self.evictions = 0
        # Moves whenever an entry is stored or dropped (not on an LRU
        # touch): CUDABackend._resident_candidates keys its memo on it.
        self.version = 0
        # The HBM ledger: key -> resident bytes split by representation tier
        # (dense / array-container / run-container source), upload epoch and
        # uploads, access count, last access and heat. Keys mirror _entries;
        # access stats survive a key's re-uploads.
        self._ledger: dict[tuple, dict] = {}
        self._upload_epoch = 0
        self._lock = InstrumentedRLock("device_stacks")
        # Per-key build latch: concurrent misses for one stack build it once.
        self._building: dict[tuple, threading.Event] = {}
        # The refresher's window (0: none; CUDABackend.start_refresher sets
        # it) and, by key, the build arguments (field, shards, view,
        # min_rows) it replays through get(): whole stacks only, as row
        # pages are paged on demand. Pruned against _entries and _building
        # under _lock in refresh_stale.
        self.refresh_window_ms = 0
        self._refresh_args: dict[tuple, tuple] = {}

    def _pad_shards(self, n: int) -> int:
        """The shard axis of a stack over n shards: n, or under a mesh the
        next multiple of its device count (ShardMesh.put's rule)."""
        return n if self.mesh is None else pad_to_multiple(n, self.mesh.n)

    def _put(self, host: np.ndarray):
        """uint32 host words -> int32 tensor with the same bits on the
        device; under a mesh a Sharded, its axis padded with zero slabs."""
        if self.mesh is not None:
            return self.mesh.put(host)
        return torch.from_numpy(host.view(np.int32)).to(self.device)

    def get(self, index: str, field_obj, shards: tuple[int, ...],
            view_name: str = VIEW_STANDARD, min_rows: int = 1):
        """Returns (stack [S, R_pad, W], rows_p), or (None, rows_p) when the
        stack cannot be resident under the byte budget. Missing fragments
        pack as zeros; under a mesh the stack is a Sharded over S_pad
        shards, the padding zero."""
        v = field_obj.view(view_name)
        # O(1) freshness: the view's generation covers every fragment
        # mutation and create/delete under it.
        fingerprint = (tuple(shards), v.generation if v is not None else -1, min_rows)
        key = (index, field_obj.name, view_name)

        def build(stale):
            # Recorded where the entry is (re)built, not on every hit: a hit
            # matched the fingerprint, so its arguments are these. A GIL-atomic
            # write; refresh_stale leaves a key that is building.
            self._refresh_args[key] = (field_obj, shards, view_name, min_rows)
            if stale is not None and self.refresh_window_ms > 0:
                # Under a window, a stale stack refreshed by the refresher
                # is a window's flush; one refreshed by a read is the
                # inline barrier firing mid-window.
                if getattr(_REFRESHER, "active", False):
                    global_stats.count("stack_windowed_refresh_total")
                else:
                    global_stats.count("stack_refresh_forced_total")
            frags = {s: (v.fragment(s) if v is not None else None) for s in shards}
            n_rows = max(
                [fr.max_row_id + 1 for fr in frags.values() if fr is not None]
                + [min_rows]
            )
            rows_p = _padded_rows(n_rows)
            s_pad = self._pad_shards(len(shards))
            shape = (s_pad, rows_p, WORDS_PER_SHARD)
            nbytes = s_pad * rows_p * WORDS_PER_SHARD * 4
            if self.max_bytes is not None and nbytes > self.max_bytes:
                # Before the version walk, which a paged field would pay on
                # every call: a stale stack of this shape would have fit,
                # so no splice is lost.
                return None, rows_p, None, None
            # Read before the pack, so a stack is never recorded as newer
            # than its content (the tables' delta replay trusts it).
            vers = tuple(_locked_version(frags[s]) for s in shards)
            updated = self._try_incremental(stale, shards, min_rows, frags, vers, rows_p)
            if updated is not None:
                # tiers None: the ledger keeps the previous split, as the
                # splice touched only the dirty shards.
                return updated, rows_p, vers, None
            if stale is not None:
                global_stats.count("stack_full_rebuilds_total")
            # Drop the stale stack before allocating its successor, so a
            # rebuild never holds two copies on the device. Its ledger
            # entry stays: access stats survive a re-upload.
            with self._lock:
                self._entries.pop(key, None)
                self.version += 1
            tiers = [0, 0]
            for fr in frags.values():
                if fr is not None:
                    a, r = fragment_tier_words(fr, rows_p)
                    tiers[0] += a
                    tiers[1] += r
            if nbytes // 4 >= sparse.MIN_CHUNKED_WORDS:
                # Under a mesh too the gate is the whole stack's, as in
                # the JAX package.
                return self._stream_build(frags, shards, rows_p, s_pad), rows_p, vers, tiers
            host = self._pack_slabs(frags, shards, range(len(shards)), rows_p)
            return self._put(host), rows_p, vers, tiers

        return self._cached_build(key, fingerprint, build)

    def _try_incremental(self, stale, shards, min_rows, frags, vers, rows_p):
        """Dirty-shard refresh: when a write epoch touched few shards of a
        resident stack of the same geometry, re-pack just those shard slabs
        and copy them into the stack in place (_splice; under a mesh
        through K15). Returns the updated stack, or None when a full
        rebuild is needed. A failed splice raises: it is not rebuilt
        around.

        In place, unlike the JAX package's new-array splice: caches keyed
        on the stack are keyed on view generations, never on the tensor's
        identity, and kernels already enqueued on the stream read the
        stack before the copy that follows them."""
        if stale is None:
            return None
        old_fp, old_arr, old_rows_p, old_vers = stale
        if (
            old_arr is None
            or old_vers is None
            or old_rows_p != rows_p
            or old_fp[0] != tuple(shards)
            or old_fp[2] != min_rows
        ):
            return None
        dirty = [i for i in range(len(shards)) if old_vers[i] != vers[i]]
        if not dirty:
            # The generation moved but no shard's version did: a write landed
            # between the stale build's generation read and its version
            # reads, so its content already holds the write. Rebuilding would
            # only replace the tensor (the JAX package, whose splice makes a
            # new array anyway, rebuilds here).
            return old_arr
        if len(dirty) > max(1, len(shards) // self.MAX_INCREMENTAL_FRACTION):
            return None
        return self._splice(old_arr, shards, frags, dirty, rows_p)

    def _pack_slabs(self, frags, shards, positions, rows_p, out=None) -> np.ndarray:
        """uint32[len(positions), rows_p, W]: the fresh packs of the shards
        at those positions of the stack's axis, zeros for a missing
        fragment; written into out (a staging buffer's view) when given."""
        if out is None:
            out = np.zeros((len(positions), rows_p, WORDS_PER_SHARD), dtype=np.uint32)
        for j, i in enumerate(positions):
            fr = frags[shards[i]]
            out[j] = pack_fragment(fr, n_rows=rows_p) if fr is not None else 0
        return out

    def _splice(self, old_arr, shards, frags, dirty, rows_p):
        """Writes the dirty shards' fresh packs into the resident stack in
        place and returns it. The dirty shards group by the part that holds
        them (the whole stack is one part unmeshed), and each part takes
        its own in rounds of at most MAX_SPLICE_ENTRIES slabs and at most
        sparse.CHUNK_WORDS words, so the staging stays bounded for any
        rows_p (_splice_round). A round is one K15 launch
        (ops/kernels.py splice_slabs) into a meshed part, or one
        index_copy_ into the unmeshed stack (the JAX package's XLA scatter,
        _update_fn, which no Pallas kernel computes).

        The JAX package ships fixed chunks instead (UPDATE_CHUNK 8
        unmeshed, MESH_UPDATE_CHUNK 1 a device meshed;
        pilosa_tpu/exec/tpu.py:180-192): XLA compiles one program per
        operand shape, and its shard_map program writes every device's
        lane each round, padding included. Neither holds here: K15 and
        index_copy_ take their shapes at run time, and a part with no
        dirty shard gets no launch, so a single dirty shard still costs
        one slab's copy and one launch."""
        meshed = isinstance(old_arr, Sharded)
        parts = old_arr.parts if meshed else [old_arr]
        s_local = int(parts[0].shape[0])
        per_round = max(1, min(MAX_SPLICE_ENTRIES,
                               sparse.CHUNK_WORDS // (rows_p * WORDS_PER_SHARD)))
        by_part: dict[int, list[int]] = {}
        for i in dirty:
            by_part.setdefault(i // s_local, []).append(i)
        held = None
        for d, items in by_part.items():
            for r0 in range(0, len(items), per_round):
                held = self._splice_round(parts[d], meshed, d * s_local, shards, frags,
                                          items[r0 : r0 + per_round], rows_p, held)
        _give_staged(held)
        global_stats.count("stack_incremental_updates_total")
        global_stats.count("stack_incremental_shards_total", len(dirty))
        return old_arr

    def _splice_round(self, part, meshed, base, shards, frags, chunk, rows_p, held):
        """One round of _splice into one part: the chunk's slabs packed
        into a staging buffer of ops/sparse.py's pool (pinned on the card),
        copied with non_blocking=True on the part's current stream (the
        readers', as the in-place contract of refresh_stale needs), and
        written there by K15 (meshed; its entries travel in the launch's
        parameters) or by index_copy_ (unmeshed; its shard indices staged
        and copied beside the slabs, in a buffer of their own). Returns the
        round's buffers with the event of its copy, which the caller gives
        back to the pool after the next round took its own (held), so a
        round packs while the last one's copy runs, and the pool hands a
        buffer out again only once its copy is done. On the CPU the same
        loop reads the slabs from an unpinned buffer in place."""
        n = len(chunk)
        local = [i - base for i in chunk]
        cuda = part.device.type == "cuda"
        slab_bytes = n * rows_p * WORDS_PER_SHARD * 4
        sizes = [slab_bytes] if meshed else [slab_bytes, 8 * n]
        staged = [sparse._take_buffer(nb, cuda) for nb in sizes]
        _give_staged(held)
        if not meshed:
            staged[1][: 8 * n].numpy().view(np.int64)[:] = local
        self._pack_slabs(frags, shards, chunk, rows_p,
                         out=staged[0][:slab_bytes].numpy().view(np.uint32)
                         .reshape(n, rows_p, WORDS_PER_SHARD))
        src = [h[:nb] for h, nb in zip(staged, sizes)]
        if cuda:
            stream = torch.cuda.current_stream(part.device)
            src = [h.to(part.device, non_blocking=True) for h in src]
        slabs = src[0].view(torch.int32).view(n, rows_p, WORDS_PER_SHARD)
        if meshed:
            splice_slabs(part, slabs, np.array(local, dtype=np.int32),
                         np.ones(n, dtype=np.uint32))
        else:
            part.index_copy_(0, src[1].view(torch.int64), slabs)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(stream)
        global_stats.count("stack_update_bytes_total", slab_bytes)
        return staged, cuda, event

    def _stream_build(self, frags, shards, rows_p, s_pad):
        """The chunked cold build (ops/sparse.py): each chunk ships on its
        cheapest wire as it packs, array and run containers as their own
        positions and spans, expanded into the stack on the card by K12 to
        K14. One ChunkedStackBuilder a part (the whole stack unmeshed; under
        a mesh the JAX package's _sharded_stream_build), on its device, fed
        the part's run of the padded shard axis in shard order, missing
        fragments and the padding tail as skip()s. Each builder is finished
        before the next starts, so one part's pinned staging is in flight
        at a time. A Sharded under a mesh."""
        devices = self.mesh.devices if self.mesh is not None else [self.device]
        s_local = s_pad // len(devices)
        slab_words = rows_p * WORDS_PER_SHARD
        parts = []
        for d, dev in enumerate(devices):
            builder = sparse.ChunkedStackBuilder(dev, (s_local, rows_p, WORDS_PER_SHARD))
            for pos in range(d * s_local, (d + 1) * s_local):
                fr = frags[shards[pos]] if pos < len(shards) else None
                if fr is not None:
                    builder.feed_fragment(fr, rows_p)
                else:
                    builder.skip(slab_words)
            parts.append(builder.finish())
        return parts[0] if self.mesh is None else Sharded(parts, real=len(shards))

    def get_row(self, index: str, field_obj, shards: tuple[int, ...],
                view_name: str, row_id: int) -> torch.Tensor:
        """[S, 1, W] single-row stack: the page of a field whose whole stack
        exceeds the byte budget. Keyed (index, field, view, "row", row_id),
        rebuilt whole when the view's generation moves, cached, LRU-evicted
        and ledgered like a stack; each costs S x 128 KiB. One row, not
        ROW_PAD: a K11 leaf takes its shard stride from the stack's height."""
        v = field_obj.view(view_name)
        fingerprint = (tuple(shards), v.generation if v is not None else -1)
        key = (index, field_obj.name, view_name, "row", row_id)

        def build(stale):
            host = np.zeros((len(shards), 1, WORDS_PER_SHARD), dtype=np.uint32)
            for i, s in enumerate(shards):
                fr = v.fragment(s) if v is not None else None
                if fr is not None and row_id <= fr.max_row_id:
                    host[i, 0] = pack_row(fr, row_id)
            page = self._put(host)
            global_stats.count("hbm_page_uploads_total")
            # The bytes placed, a mesh's zero padding included, as the JAX
            # package counts them.
            global_stats.count("hbm_page_bytes_total", page.nbytes)
            return page, 1, None, None

        return self._cached_build(key, fingerprint, build)[0]

    def get_with_versions(self, index: str, field_obj, shards: tuple[int, ...],
                          view_name: str = VIEW_STANDARD, min_rows: int = 1):
        """get() plus the per-shard (uid, version) tuple the returned stack
        was packed from."""
        block, rows_p = self.get(index, field_obj, shards, view_name, min_rows)
        with self._lock:
            ent = self._entries.get((index, field_obj.name, view_name))
            vers = ent[3] if ent is not None and ent[1] is block else None
        return block, rows_p, vers

    def _cached_build(self, key: tuple, fingerprint: tuple, build):
        """Hit / latch / build / evict, for stacks and row pages alike.
        build(stale) receives the stale entry for this key (or None) and
        returns (tensor_or_None, rows_p, versions, tier words or None); None
        means 'cannot be resident' and is not cached. A hit bumps the
        entry's ledger stats, an upload records one; both are offered to the
        reuse-distance estimator (a queue append, recorded at the next
        readback: CUDABackend._readback)."""
        while True:
            with self._lock:
                cached = self._entries.get(key)
                if cached is not None and cached[0] == fingerprint:
                    self._entries[key] = self._entries.pop(key)  # LRU touch
                    led = self._ledger.get(key)
                    if led is not None:
                        self._bump_heat(led)
                    self.reuse.offer(key, led["bytes"] if led is not None else 0)
                    return cached[1], cached[2]
                latch = self._building.get(key)
                if latch is None:
                    self._building[key] = threading.Event()
                    break
            latch.wait()
        try:
            arr, rows_p, vers, tiers = build(cached)
            if arr is None:
                return None, rows_p
            with self._lock:
                self._entries.pop(key, None)
                self._entries[key] = (fingerprint, arr, rows_p, vers)
                self.version += 1
                self._ledger_upload(key, arr, tiers)
                self._evict(keep=key)
            # Misses are references too: without them every distance in
            # the reuse stream would look resident.
            self.reuse.offer(key, arr.numel() * 4)
            return arr, rows_p
        finally:
            with self._lock:
                self._building.pop(key).set()

    def _ledger_upload(self, key: tuple, arr: torch.Tensor, tiers) -> None:
        """Record a (re)upload in the HBM ledger (caller holds _lock). Access
        stats survive re-uploads of the same key. tiers None with an
        unchanged byte size keeps the previous tier split (an in-place
        splice does not re-attribute); otherwise bytes not attributed to
        array or run containers are dense."""
        nbytes = arr.numel() * 4
        self._upload_epoch += 1
        led = self._ledger.get(key)
        if led is None:
            led = {"access_count": 0, "uploads": 0}
            self._ledger[key] = led
        if tiers is None and led.get("bytes") == nbytes and "tier_bytes" in led:
            tier_bytes = led["tier_bytes"]
        else:
            array_b = min(int(tiers[0]) * 4, nbytes) if tiers else 0
            run_b = min(int(tiers[1]) * 4, nbytes - array_b) if tiers else 0
            tier_bytes = {"dense": nbytes - array_b - run_b, "array": array_b, "run": run_b}
        led.update(bytes=nbytes, tier_bytes=tier_bytes, upload_epoch=self._upload_epoch)
        led["uploads"] += 1
        self._bump_heat(led)

    def _bump_heat(self, led: dict) -> None:
        """One access of a ledger entry (caller holds _lock): the stored heat
        decays by 2^(-idle / half-life) since the last access, then gains
        this access."""
        now = time.monotonic()
        heat = led.get("heat", 0.0)
        if heat:
            heat *= 2.0 ** ((led["last_access"] - now) / self.heat_half_life)
        led["heat"] = heat + 1.0
        led["access_count"] += 1
        led["last_access"] = now

    def peek(self, index: str, field_name: str, view_name: str = VIEW_STANDARD):
        """The resident stack of a key, or None. Never builds: preheat's
        launches must not upload or evict."""
        with self._lock:
            ent = self._entries.get((index, field_name, view_name))
            return ent[1] if ent is not None else None

    def refresh_stale(self) -> int:
        """One window's flush: re-run get() for every resident stack whose
        view generation moved since its upload, so the shards the window
        dirtied are spliced in once (_try_incremental) and the reads after
        the window find a fresh stack. Returns the stacks refreshed. A
        failed refresh is dropped: the next read refreshes inline.

        The splice writes the resident tensor in place, on the stream the
        readers launch on (the device's current stream, as a read's inline
        splice does): a launch enqueued before the copy reads the old
        content, one enqueued after it the new. The tables that keep host
        rows confirm the versions they recorded after their sweep
        (CUDABackend._confirm_vers), so a splice racing a sweep marks its
        shards stale instead of being counted twice."""
        with self._lock:
            for k in list(self._refresh_args):
                if k not in self._entries and k not in self._building:
                    del self._refresh_args[k]
            work = list(self._refresh_args.items())
        n = 0
        for key, (field_obj, shards, view_name, min_rows) in work:
            try:
                v = field_obj.view(view_name)
            except Exception:  # lint: allow-except-exception(field deleted mid-walk: the entry prunes on the next round)
                continue
            gen = v.generation if v is not None else -1
            with self._lock:
                ent = self._entries.get(key)
                if ent is None or ent[0] == (tuple(shards), gen, min_rows):
                    continue  # evicted, or already fresh
            _REFRESHER.active = True
            try:
                self.get(key[0], field_obj, shards, view_name, min_rows)
                n += 1
            except Exception:  # lint: allow-except-exception(a failed background round is dropped; the read path refreshes inline and raises there)
                pass
            finally:
                _REFRESHER.active = False
        return n

    def make_room(self, nbytes: int) -> None:
        """LRU-evict cached entries until `nbytes` fits under the budget (a
        page sweep's transient page stays inside it)."""
        if self.max_bytes is None:
            return
        with self._lock:
            target = max(0, self.max_bytes - nbytes)
            while self.resident_bytes() > target and self._entries:
                self._drop(next(iter(self._entries)))

    def _evict(self, keep: tuple) -> None:
        if self.max_bytes is None:
            return
        while self.resident_bytes() > self.max_bytes and len(self._entries) > 1:
            self._drop(next(k for k in self._entries if k != keep))

    def _drop(self, victim: tuple) -> None:
        self._entries.pop(victim)
        self.version += 1
        self._ledger.pop(victim, None)
        self.evictions += 1

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e[1].numel() * 4 for e in self._entries.values())

    def resident_shard_sets(self, index: str) -> list[tuple[int, ...]]:
        """The distinct shard tuples of the index's resident stacks and row
        pages, most recently used first."""
        with self._lock:
            items = list(self._entries.items())
        out: list = []
        for key, entry in reversed(items):
            if key[0] == index and entry[0][0] not in out:
                out.append(entry[0][0])
        return out

    def tier_bytes(self) -> dict[str, int]:
        """Resident bytes by representation tier; the dict sums exactly to
        resident_bytes() (each ledger entry's tiers sum to its bytes)."""
        out = {"dense": 0, "array": 0, "run": 0}
        with self._lock:
            for key in self._entries:
                led = self._ledger.get(key)
                if led is None:
                    continue
                for t, b in led["tier_bytes"].items():
                    out[t] += b
        return out

    def ledger(self) -> list[dict]:
        """The per-entry HBM ledger, coldest first: the LRU order in which
        _evict takes victims (served at /debug/hbm). A row page's entry
        names its row."""
        # Idle ages run on the monotonic clock; one wall-clock read maps
        # them onto the operator-facing lastAccess stamps.
        now = time.monotonic()
        wall = time.time()  # lint: allow-monotonic-time(lastAccess is an operator-facing epoch display; idleSeconds math is monotonic)
        out = []
        with self._lock:
            for key, (_, _, rows_p, _) in self._entries.items():
                led = self._ledger.get(key)
                if led is None:
                    continue
                ent = {
                    "index": key[0],
                    "field": key[1],
                    "view": key[2],
                    "bytes": led["bytes"],
                    "tierBytes": dict(led["tier_bytes"]),
                    "rows": rows_p,
                    "uploadEpoch": led["upload_epoch"],
                    "uploads": led["uploads"],
                    "accessCount": led["access_count"],
                    "lastAccess": round(wall - (now - led["last_access"]), 3),
                    "idleSeconds": round(now - led["last_access"], 3),
                }
                if len(key) > 3 and key[3] == "row":
                    ent["row"] = key[4]
                arr = self._entries[key][1]
                if isinstance(arr, Sharded):
                    ent["partBytes"] = arr.part_bytes()
                out.append(ent)
        return out

    def heat_snapshot(self, entries: int = -1) -> dict:
        """Per-entry decayed-frequency heat, decayed to now, hottest first,
        and the per-tier rollup behind the hbm_access_heat{tier} gauges: an
        entry's heat splits over its tiers by their share of its bytes.
        entries: -1 all, 0 the rollup only, N > 0 the hottest N. Records
        the reuse estimator's queue first, so a /metrics scrape
        (publish_hbm_gauges) publishes reuse_distance_samples_total whole."""
        self.reuse.flush()
        now = time.monotonic()
        hl = self.heat_half_life
        tier_heat = {"dense": 0.0, "array": 0.0, "run": 0.0}
        ents: list[dict] = []
        with self._lock:
            for key in self._entries:
                led = self._ledger.get(key)
                if led is None:
                    continue
                heat = led.get("heat", 0.0) * 2.0 ** ((led["last_access"] - now) / hl)
                b = led["bytes"] or 1
                for t, tb in led["tier_bytes"].items():
                    tier_heat[t] += heat * (tb / b)
                if entries == 0:
                    continue
                ent = {
                    "index": key[0],
                    "field": key[1],
                    "view": key[2],
                    "bytes": led["bytes"],
                    "heat": round(heat, 4),
                    "accessCount": led["access_count"],
                    "idleSeconds": round(now - led["last_access"], 3),
                }
                if len(key) > 3 and key[3] == "row":
                    ent["row"] = key[4]
                ents.append(ent)
        ents.sort(key=lambda e: e["heat"], reverse=True)
        if entries > 0:
            ents = ents[:entries]
        return {
            "halfLifeSeconds": hl,
            "tierHeat": {t: round(v, 4) for t, v in tier_heat.items()},
            "entries": ents,
        }


class _PairEntry:
    """One field pair's cached sufficient statistics: the in-flight flat
    table right after a sweep (per-shard int32[S, D] or summed int32[D]),
    replaced by the int64 host totals on first resolve. pershard: the
    per-shard int32[S, D] host table the totals sum (None for a summed
    sweep, and until the first resolve), which absorbs write epochs
    (_pair_try_incremental). gen_*: the views' generations it was keyed on,
    the O(1) freshness gate. vers_*: the per-shard (uid, version) it
    describes, diffed only when a generation moved."""

    __slots__ = ("shards", "rf", "rg", "stats", "pershard",
                 "gen_f", "gen_g", "vers_f", "vers_g")

    def __init__(self, shards, rf, rg, stats, pershard, gen_f, gen_g, vers_f, vers_g):
        self.shards = shards
        self.rf = rf
        self.rg = rg
        self.stats = stats
        self.pershard = pershard
        self.gen_f = gen_f
        self.gen_g = gen_g
        self.vers_f = vers_f
        self.vers_g = vers_g


class _GroupNEntry:
    """One N>=3 field tuple's cached group tensor: totals int64[K, rf, rg]
    served to queries, the per-shard int32[S, K*rf*rg] table they were
    summed from, which absorbs write epochs (_groupn_try_incremental), the
    row counts (padded stack heights) fixing the tensor geometry, and per
    field the per-shard (uid, version) the table describes. cfp: the
    (shards, view generations) it is keyed on."""

    __slots__ = ("cfp", "stats", "pershard", "rs", "vers")

    def __init__(self, cfp, stats, pershard, rs, vers):
        self.cfp = cfp
        self.stats = stats
        self.pershard = pershard
        self.rs = rs
        self.vers = vers


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _first_sharded(args) -> Optional[Sharded]:
    """The first Sharded at any depth of an argument tuple, or None."""
    for a in args:
        if isinstance(a, Sharded):
            return a
        if isinstance(a, (tuple, list)):
            found = _first_sharded(a)
            if found is not None:
                return found
    return None


def _part_args(args, d: int):
    """args with every Sharded (at any depth of a tuple or list) replaced by
    its part d."""
    out = []
    for a in args:
        if isinstance(a, Sharded):
            a = a.parts[d]
        elif isinstance(a, (tuple, list)):
            a = type(a)(_part_args(a, d))
        out.append(a)
    return out


def _row_counts_summed(n_rows: int):
    """K8's per-row counts of rows 0 .. n_rows of (stack, masks), summed
    over the shards in int64: a program body for CUDABackend._run."""

    def body(block, masks):
        return row_popcounts(block, 0, n_rows, masks)[0].sum(dim=0, dtype=torch.int64)

    return body


def _stack_row_counts(stack):
    """Each row's popcount over every shard of a stack [S, R, W], int64[R]:
    K3 over its [S * R, W] view, summed over the shards."""
    s, r, w = stack.shape
    return popcount_rows(stack.reshape(s * r, w)).reshape(s, r).sum(dim=0, dtype=torch.int64)


def _sum_masks(bsi_block, filt):
    """Sum's column masks of a BSI stack [S, R, W] under a filter slab (or
    None): the positive and the negative considered columns and the
    considered ones, each int32[S, W]."""
    consider = bsi_block[:, BSI_EXISTS_BIT, :]
    if filt is not None:
        consider = consider & filt
    neg = (bsi_block[:, BSI_SIGN_BIT, :] & consider).contiguous()
    pos = (consider & ~neg).contiguous()
    return pos, neg, consider.contiguous()


def _real_shards(block) -> int:
    """The shard count a stack or slab holds before any mesh padding."""
    return block.real if isinstance(block, Sharded) else int(block.shape[0])


def _shift_slab(slab, n: int):
    """Shift all bits up by n within each shard slab (word axis last,
    little-endian bit order within the words). Bits crossing the shard
    boundary drop, as segment-local Row.Shift (core/row.py) does. On int32
    words ``>>`` is arithmetic, so the carried high bits are masked to
    act as the logical shift; ``<<`` wraps past the sign bit."""
    if n == 0:
        return slab
    s_words, s_bits = divmod(n, 32)
    w = slab.shape[-1]

    def word_shifted(k):
        out = torch.zeros_like(slab)
        if k < w:
            out[..., k:] = slab[..., : w - k]
        return out

    lo = word_shifted(s_words)
    if s_bits == 0:
        return lo
    hi = word_shifted(s_words + 1)
    return (lo << s_bits) | ((hi >> (32 - s_bits)) & ((1 << s_bits) - 1))


def _pred_bits(value: int, depth: int) -> tuple:
    return tuple((value >> i) & 1 for i in range(depth))


def _take_row(block, row, mask):
    """Row ``row`` of every shard of [S, R, W] as [S, W]; an empty row when
    ``mask`` is 0 (a row beyond the packed range)."""
    if not mask:
        return torch.zeros_like(block[:, 0, :])
    idx = torch.tensor([row], dtype=torch.int64, device=block.device)
    return torch.index_select(block, 1, idx).squeeze(1)


def _eval_spec(spec, blocks_it, scalars_it) -> torch.Tensor:
    """Evaluate a spec tree over [S, W] int32 slabs with torch ops, node by
    node (the JAX package's _eval_spec, pilosa_tpu/exec/tpu.py:1204). Both
    iterators are consumed in the exact order _build emitted them. The
    backend's programs run the tree as one K11 program instead (_spec_run);
    this walk is the independent reference they are tested against."""
    tag = spec[0]
    if tag == "R":
        block = next(blocks_it)  # [S, R, W]
        row = next(scalars_it)
        return _take_row(block, row, next(scalars_it))
    if tag == "T":
        # Time-range row: union of per-view row slabs (executor.go:1441).
        acc = None
        for _ in range(spec[2]):
            block = next(blocks_it)
            row = next(scalars_it)
            slab = _take_row(block, row, next(scalars_it))
            acc = slab if acc is None else acc | slab
        return acc
    if tag == "A":
        return next(blocks_it)[:, 0, :]  # existence stack
    if tag == "N":
        block = next(blocks_it)  # existence stack
        inner = _eval_spec(spec[1], blocks_it, scalars_it)
        return block[:, 0, :] & ~inner
    if tag == "E":
        return torch.zeros_like(next(blocks_it)[:, 0, :])  # block: shape only
    if tag == "NN":
        return next(blocks_it)[:, BSI_EXISTS_BIT, :]
    if tag == "C":
        # BSI comparison: ("C", field, op, neg_pred, allow_eq, depth), one K10
        _, _fname, op, neg, allow_eq, depth = spec
        block = next(blocks_it)
        bits = next(scalars_it)
        return bsi_compare(block, depth, op, bits, neg=neg, allow_eq=allow_eq)
    if tag == "CB":
        # BSI between: ("CB", field, cls, depth), fragment.rangeBetween :1504
        _, _fname, cls, depth = spec
        block = next(blocks_it)
        lo_bits = next(scalars_it)
        hi_bits = next(scalars_it)
        return bsi_compare(block, depth, cls, lo_bits, hi_bits=hi_bits)
    if tag == "S":
        return _shift_slab(_eval_spec(spec[2], blocks_it, scalars_it), spec[1])
    children = spec[1]
    acc = _eval_spec(children[0], blocks_it, scalars_it)
    for ch in children[1:]:
        v = _eval_spec(ch, blocks_it, scalars_it)
        if tag == "U":
            acc = acc | v
        elif tag == "I":
            acc = acc & v
        elif tag == "D":
            acc = acc & ~v
        elif tag == "X":
            acc = acc ^ v
    return acc


def _shape_sig(tree) -> tuple[tuple, int]:
    """(hashable nested (dtype, shape) signature, total bytes) of a launch's
    argument tree, in one walk that reads the tensors' shapes, never their
    values. (kind, key, shape signature) names one program of the ledger;
    the bytes are a launch record's bytesShipped. The dtype and shape
    objects are kept as they are (a torch.Size is a tuple): _sig_text
    spells them for display, once a program."""
    out = []
    nbytes = 0
    for a in tree:
        if isinstance(a, _SIG_LEAVES):
            out.append((a.dtype, a.shape))
            nbytes += a.nbytes
        elif isinstance(a, (tuple, list)):
            sig, n = _shape_sig(a)
            out.append(sig)
            nbytes += n
        else:
            out.append(type(a).__name__)
    return tuple(out), nbytes


def _sig_text(shape_sig) -> str:
    """A shape signature as text: ('int32', (954, 8, 32768)) a tensor."""

    def plain(sig):
        if (isinstance(sig, tuple) and len(sig) == 2 and not isinstance(sig[0], tuple)
                and isinstance(sig[1], tuple) and all(isinstance(d, int) for d in sig[1])):
            return (str(sig[0]).removeprefix("torch."), tuple(sig[1]))
        if isinstance(sig, tuple):
            return tuple(plain(x) for x in sig)
        return sig

    return repr(plain(shape_sig))[:200]


def _tree_nbytes(tree) -> int:
    """Total tensor bytes in a (possibly nested) output tree: a launch
    record's bytesReturned. Walked only when a profile is active."""
    if isinstance(tree, (tuple, list)):
        return sum(_tree_nbytes(a) for a in tree)
    return int(getattr(tree, "nbytes", 0) or 0)


def _sig_occupancy(shape_sig) -> Optional[int]:
    """Largest leading dim among rank-1 leaves of a shape signature: the
    slot count Q of a batched launch (None when it has no per-slot
    operand)."""
    best = None
    for leaf in shape_sig:
        if isinstance(leaf, tuple) and leaf and isinstance(leaf[0], tuple):
            inner = _sig_occupancy(leaf)
            if inner is not None:
                best = inner if best is None else max(best, inner)
        elif (
            isinstance(leaf, tuple) and len(leaf) == 2
            and isinstance(leaf[1], tuple) and len(leaf[1]) == 1
        ):
            n = int(leaf[1][0])
            best = n if best is None else max(best, n)
    return best


class _Slots:
    """The slot axis of a K11 launch as a launch argument: shape (Q,), and
    the bytes of its [Q, leaves] int32 row table, which the launch ships."""

    __slots__ = ("shape", "nbytes")
    dtype = "slots"

    def __init__(self, q: int, n_leaves: int):
        self.shape = (q,)
        self.nbytes = 4 * q * n_leaves


# The leaves of a launch's argument tree that have a shape and bytes.
_SIG_LEAVES = (torch.Tensor, _Slots, Sharded)
_SLOTS: dict = {}


def _slots(q: int, n_leaves: int) -> _Slots:
    """The _Slots of (q, n_leaves), made once."""
    s = _SLOTS.get((q, n_leaves))
    if s is None:
        s = _SLOTS[(q, n_leaves)] = _Slots(q, n_leaves)
    return s


class _ProgramEntry:
    """Ledger row for one program (see _ProgramLedger)."""

    __slots__ = (
        "kind", "program", "bucket", "shapes", "compiles",
        "compile_seconds", "launches", "device_seconds", "waits",
        "last_launch",
    )

    def __init__(self, kind: str, program: str, bucket, shapes: str):
        self.kind = kind
        self.program = program
        self.bucket = bucket
        self.shapes = shapes
        self.compiles = 0
        self.compile_seconds = 0.0
        self.launches = 0
        self.device_seconds = 0.0
        # Device seconds closed by block_ready, not yet in device_seconds:
        # appended without the ledger's lock, folded under it (_fold).
        self.waits: list = []
        self.last_launch = 0.0   # perf_counter of the last dispatch


class _ProgramLedger:
    """Device-program ledger: every program the backend launched, keyed by
    (kind, key, argument shape signature), served coldest first at
    GET /debug/programs. Registration is at the launch chokepoint
    (CUDABackend._launched), so the ledger sees the launches that
    device_launches_total counts.

    A compile here is the one load of the kernel libraries in the process
    (ops/build.py: nvcc runs for a source that changed, then the libraries
    are loaded): the first launch after it records it, with the load's
    wall as its compile seconds (device_compile_seconds{kind}). A new shape
    compiles nothing, as the kernels take their shapes at run time, and on
    the CPU nothing compiles. A compile of a signature already in the
    ledger is a recompile (device_recompiles_total{kind}); since the load
    happens once, that count stays 0 in one process. The entry count is
    the device_programs_live gauge.

    Device time: each launch parks (entry, dispatch t0) on the dispatching
    thread, at most _PENDING_CAP of them; block_ready(), called right after
    a synchronizing readback, closes every parked launch of that thread
    into its entry's device seconds.

    Host cost: a launch takes the ledger's lock once (record_launch) and
    reads no clock of its own (its dispatch t0 is the caller's); the
    readback closes its launches without the lock, and reads fold them in
    (_fold). lastLaunch's epoch stamp is derived when the ledger is read."""

    _PENDING_CAP = 64
    # Closed waits an entry holds before record_launch folds them.
    _FOLD_AT = 32

    def __init__(self, stats):
        self._lock = threading.Lock()
        self._entries: dict[tuple, _ProgramEntry] = {}
        self._stats = stats
        self._local = threading.local()

    def record_launch(self, kind: str, key, shape_sig: tuple, t_dispatch: float):
        """Record one launch of the program (kind, key, shape_sig),
        dispatched at t_dispatch (perf_counter), and return its compile
        seconds: the library load, when this is the first launch after it,
        else None."""
        sig = (kind, key, shape_sig)
        with self._lock:
            e = self._entries.get(sig)
            if e is None:
                e = self._entries[sig] = _ProgramEntry(
                    kind,
                    repr(key)[:120] if key is not None else kind,
                    _sig_occupancy(shape_sig),
                    _sig_text(shape_sig),
                )
            e.launches += 1
            e.last_launch = t_dispatch
            if len(e.waits) >= self._FOLD_AT:
                self._fold(e)
        try:
            pend = self._local.pending
        except AttributeError:
            pend = self._local.pending = []
        if len(pend) < self._PENDING_CAP:
            pend.append((e, t_dispatch))
        compile_seconds = take_load_seconds()
        if compile_seconds is not None:
            self._compiled(kind, e, compile_seconds)
        return compile_seconds

    def _compiled(self, kind: str, e: _ProgramEntry, seconds: float) -> None:
        with self._lock:
            e.compiles += 1
            e.compile_seconds += seconds
            recompile = e.compiles > 1
            live = len(self._entries)
        st = self._stats.with_tags(f"kind:{kind}")
        st.timing("device_compile_seconds", seconds)
        if recompile:
            st.count("device_recompiles_total")
        self._stats.gauge("device_programs_live", live)

    def block_ready(self) -> None:
        """Close this thread's parked launches into their entries' device
        seconds; the caller has just synchronized with the card (a readback
        to the host). Lock-free: a list append is atomic, and _fold takes
        the closed waits under the lock."""
        pend = getattr(self._local, "pending", None)
        if pend:
            now = time.perf_counter()
            for e, t0 in pend:
                e.waits.append(now - t0)
            pend.clear()

    @staticmethod
    def _fold(e: _ProgramEntry) -> None:
        """Move an entry's closed waits into its device seconds (caller
        holds _lock; block_ready only appends, so the prefix it takes is
        whole)."""
        w = e.waits
        n = len(w)
        if n:
            e.device_seconds += sum(w[:n])
            del w[:n]

    def _entries_folded(self) -> list:
        with self._lock:
            entries = list(self._entries.values())
            for e in entries:
                self._fold(e)
        return entries

    def ledger(self) -> list[dict]:
        """Ledger rows, coldest first (longest since the last launch), as
        /debug/hbm lists its entries."""
        entries = self._entries_folded()
        now = time.perf_counter()
        # lint: allow-monotonic-time(operator-facing epoch display stamp)
        wall = time.time()
        entries.sort(key=lambda e: e.last_launch)
        return [
            {
                "kind": e.kind,
                "program": e.program,
                "bucket": e.bucket,
                "shapes": e.shapes,
                "compiles": e.compiles,
                "compileSeconds": round(e.compile_seconds, 6),
                "launches": e.launches,
                "deviceSeconds": round(e.device_seconds, 6),
                "lastLaunch": wall - (now - e.last_launch) if e.last_launch else None,
                "idleSeconds": (
                    round(now - e.last_launch, 3) if e.last_launch else None
                ),
            }
            for e in entries
        ]

    def counts(self) -> dict:
        entries = self._entries_folded()
        return {
            "programs": len(entries),
            "compiles": sum(e.compiles for e in entries),
            "recompiles": sum(max(0, e.compiles - 1) for e in entries),
            "launches": sum(e.launches for e in entries),
        }


class CUDABackend:
    """Device backend for the Executor: bitmap calls, Count, TopN, Rows,
    Sum, Min, Max and GroupBy on the card.

    ``device`` defaults to "cuda" and must name a present device; the CPU
    tests pass device="cpu", where every kernel wrapper takes its plain
    PyTorch version. Calls not lowered here go to the CPU oracle.

    ``mesh`` (parallel/mesh.py ShardMesh, of devices of ``device``'s type)
    shards every stack over its devices; a mesh of one device is none. Each
    program then runs its kernels once on every part (_run) and merges the
    parts' partial results on the mesh's first device, the backend's
    device: summed in int64 (the JAX package's psum) or gathered in shard
    order with the padding cut. One program is one launch at the
    chokepoint (_launched), whatever the number of parts."""

    _PAIR_VERBS = {"Intersect": "I", "Union": "U", "Difference": "D", "Xor": "X"}

    #: Per-shard table retention gate: beyond this the pair sweep returns
    #: device-summed totals instead of the per-shard table.
    MAX_PAIR_PERSHARD_BYTES = 32 << 20

    #: Host-update cutoff of the pair and TopN tables: up to this many
    #: shards an epoch re-derives from host-packed slabs; past it one
    #: sweep on the card does.
    MAX_PAIR_HOST_UPDATE_SHARDS = 64

    #: Slab-tier budget of the N-field group table: words ANDed an epoch
    #: (K * rf * rg * W a slab shard). Past it one sweep on the card does.
    MAX_GROUPN_HOST_SLAB_WORDS = 1 << 29

    #: Queued stack references the reuse estimator records at a readback,
    #: while the card runs: a few Counts' worth, so its lock and counter
    #: are paid once for several.
    _REUSE_BATCH = 8

    def __init__(self, holder, device="cuda", max_bytes: Optional[int] = None,
                 heat_half_life: Optional[float] = None, mesh=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDABackend: no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if device.type == "cuda" and device.index is None:
            # Pin the index: server handler threads each have their own
            # current device, and every allocation and launch names this one.
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = mesh if mesh is not None and mesh.n > 1 else None
        if mesh is not None:
            if any(d.type != device.type for d in mesh.devices):
                raise ValueError(
                    f"CUDABackend: a mesh over {mesh.devices[0].type} devices needs "
                    f"device={mesh.devices[0].type!r}")
            device = mesh.devices[0]  # where the parts' results merge
        self.holder = holder
        self.device = device
        self.mesh = mesh
        self.cpu = CPUBackend(holder)
        self.stats = global_stats
        self.blocks = _StackedBlocks(device, max_bytes, heat_half_life, mesh)
        # Cluster seam (cluster/cluster.py attach): (index, shards) -> the
        # shards among them that this node holds. None on a single node,
        # which holds every shard.
        self.held_shards: Optional[Callable] = None
        # Memos by index of _held (the available-shards list it was taken
        # from, the held tuple) and of _resident_candidates (the held tuple,
        # blocks.version, the candidates): a clustered coordinator asks for
        # one shard at a time, and each ask stays O(1) until a stack is
        # stored or dropped, the shard set moves or the topology changes.
        self._held_memo: dict = {}
        self._resident_memo: dict = {}
        # Device-program ledger behind GET /debug/programs, fed by _launched,
        # and its counters' tagged clients by kind.
        self.programs = _ProgramLedger(self.stats)
        self._kind_stats: dict = {}
        # The windowed refresher (start_refresher), when refresh-window-ms > 0.
        self._refresher: Optional[threading.Thread] = None
        self._refresher_stop: Optional[threading.Event] = None
        # Pair-stats cache: (index, fa, fb) -> _PairEntry, keyed fresh on
        # the two views' generations. Guarded: resolvers run on server
        # worker threads.
        self._pair_cache: dict = {}
        self._pair_lock = threading.Lock()
        # Single-flight latches for pair refreshes.
        self._stats_updating: dict = {}
        # Pair-plan memo keyed by the (parse-cached, shared) calls' ids.
        self._plan_cache: dict = {}
        self._plan_lock = threading.Lock()
        # Under _pair_lock: GroupBy tensors, (cfp, payload) by ("groupby",
        # index, fields, filter), beside the unfiltered Sum/Min/Max results,
        # (cfp, (value, count), extra) by (kind, index, field) (extra: the
        # state their host tiers update, see _agg_store); the N>=3
        # per-shard tables (_GroupNEntry); and the TopN rank vectors, (cfp, int64[R]
        # row counts, int64[S, R] per-shard table or None, per-shard
        # versions) by (index, field).
        self._agg_cache: dict = {}
        self._groupn_cache: dict = {}
        self._topn_cache: dict = {}

    # -- routing and counters ----------------------------------------------

    def _cpu_routed(self, c: Call) -> None:
        """Count a call answered by the CPU oracle (call: the PQL call name,
        a bounded label)."""
        self.stats.with_tags(f"call:{c.name}").count("cpu_routed_total")

    def _launched(self, kind: str, key, args, launch):
        """The launch chokepoint: run launch(), the kernel wrapper call(s) of
        one launch of program `key` over `args`, and return its output.
        Counts device_launches_total{kind}, records the launch in the
        program ledger and, under an active profile, adds its dispatch wall
        to device_wait_us, its argument and output bytes to bytes_shipped
        and bytes_returned, and one launch record to an EXPLAIN plan. An
        unprofiled launch pays only the counter and the ledger."""
        t0 = time.perf_counter()
        with trace_range("pilosa.launch.", kind):
            out = launch()
        wall = time.perf_counter() - t0
        # The bookkeeping runs while the card runs the launch.
        stats = self._kind_stats.get(kind)
        if stats is None:
            stats = self._kind_stats[kind] = self.stats.with_tags(f"kind:{kind}")
        stats.count("device_launches_total")
        shape_sig, shipped = _shape_sig(args)
        loaded = self.programs.record_launch(kind, key, shape_sig, t0)
        prof = current_profile()
        if prof is not NOP_PROFILE:
            returned = out.nbytes if isinstance(out, torch.Tensor) else _tree_nbytes(out)
            c = prof.counters
            c["device_launches"] = c.get("device_launches", 0) + 1
            c["device_wait_us"] = c.get("device_wait_us", 0) + int(wall * 1e6)
            c["bytes_shipped"] = c.get("bytes_shipped", 0) + shipped
            c["bytes_returned"] = c.get("bytes_returned", 0) + returned
            ex = prof.explain
            if ex is not None:
                ex.add_launch({
                    "kind": kind,
                    "program": kind if key is None else repr(key)[:120],
                    "shapes": _sig_text(shape_sig),
                    "occupancy": _sig_occupancy(shape_sig),
                    "compiled": loaded is not None,
                    "dispatchMs": round(wall * 1e3, 3),
                    "bytesShipped": shipped,
                    "bytesReturned": returned,
                    "devices": self.mesh.n if self.mesh is not None else 1,
                })
        return out

    def _run(self, fn, args: tuple, merge=None, axis: int = 0):
        """The body of one program: fn(*args) once, or, when args hold a
        Sharded (at any depth of a tuple or list), once on each of its parts
        with every Sharded replaced by its part (any other argument goes to
        every part as it is). Each part's kernels launch on the part's
        device (ops/kernels.py _launch takes it from the tensors), in mesh
        order. merge joins the parts' outputs on the first part's device:

        - None: a Sharded of them (a tuple of Sharded for tuple outputs),
          each left on its part's device, their axis ``axis`` the shard
          axis;
        - "psum": their sum in int64 (fn returns its part's int64 sums);
        - an int d: concatenated along axis d in shard order, cut at the
          real shard count.

        With no Sharded among args (no mesh, or a call narrowed to one
        shard) fn's output is returned as it is."""
        sh = None if self.mesh is None else _first_sharded(args)
        if sh is None:
            return fn(*args)
        outs = []
        for d in range(len(sh.parts)):
            with trace_range("pilosa.part.", d):
                outs.append(fn(*_part_args(args, d)))
        if merge is None:
            if isinstance(outs[0], tuple):
                return tuple(Sharded([o[k] for o in outs], sh.real, axis)
                             for k in range(len(outs[0])))
            return Sharded(outs, sh.real, axis)
        dev = sh.device
        if merge == "psum":
            total = outs[0].to(torch.int64)
            for o in outs[1:]:
                total = total + o.to(device=dev, dtype=torch.int64)
            return total
        out = torch.cat([o.to(dev) for o in outs], dim=merge)
        return out if out.shape[merge] == sh.real else out.narrow(merge, 0, sh.real)

    def _readback(self, t: torch.Tensor) -> np.ndarray:
        """t on the host as numpy. The copy waits for the card, so this
        thread's parked launches close into the ledger's device seconds;
        before it, the reuse estimator records its queue while the card
        runs."""
        self.blocks.reuse.flush(self._REUSE_BATCH)
        host = t.cpu().numpy()
        self.programs.block_ready()
        return host

    # -- windowed refresher and preheat ------------------------------------

    def start_refresher(self, window_ms: float) -> None:
        """Start the windowed refresher: every window it splices the shards
        dirtied since the last round into each resident stack
        (blocks.refresh_stale), one incremental round a stack. Idempotent;
        a window of 0 keeps it off (reads refresh inline)."""
        if window_ms <= 0 or self._refresher is not None:
            return
        self.blocks.refresh_window_ms = window_ms
        stop = threading.Event()
        self._refresher_stop = stop

        def _loop():
            while not stop.wait(window_ms / 1000.0):
                try:
                    self.blocks.refresh_stale()
                except Exception:  # lint: allow-except-exception(one failed round must not end the refresher; reads refresh inline)
                    pass

        from pilosa_tpu_torch.utils.threads import spawn

        self._refresher = spawn("device-refresh", _loop, name="stack-refresh")

    def stop_refresher(self) -> None:
        """Stop the refresher and wait for its round in flight, so the window
        is cleared only once no refresh is running (its splices are counted
        as windowed) and a start_refresher after it runs one thread."""
        if self._refresher is not None:
            self._refresher_stop.set()
            self._refresher.join()
            self._refresher = None
            self._refresher_stop = None
            self.blocks.refresh_window_ms = 0

    def preheat(self, logger=None) -> int:
        """Pack and upload every field's stacks (each view, over its index's
        shard union, BSI views at full plane height) so the first queries
        skip the cold pack and upload, and load the kernel libraries
        (_preheat_programs). Returns the stacks made resident. Under a byte
        budget it stops at the first upload that evicted: later ones would
        only evict earlier ones. A stack over the budget is skipped (it is
        paged). Best-effort: a failure is logged and the walk goes on."""
        n = 0
        for iname in list(self.holder.indexes):
            idx = self.holder.index(iname)
            if idx is None:
                continue
            # Queries assemble against the index-wide shard union, or in a
            # cluster the shards this node holds, so the stacks are keyed
            # the same way, or the first query would replace them.
            shards = self._held(iname)
            if not shards:
                continue
            for fname in list(idx.fields):
                try:
                    f = idx.field(fname)
                    if f is None:
                        continue
                    for view_name in list(f.views):
                        min_rows = 1
                        if view_name == bsi_view_name(fname) and (
                            f.options.type == FIELD_TYPE_INT
                        ):
                            min_rows = BSI_OFFSET_BIT + f.options.bit_depth
                        ev_before = self.blocks.evictions
                        block, _ = self.blocks.get(iname, f, shards, view_name, min_rows)
                        if self.blocks.evictions > ev_before:
                            if logger is not None:
                                logger.printf("preheat: HBM budget reached at %s/%s",
                                              iname, fname)
                            self._preheat_programs(logger)
                            return n
                        if block is not None:
                            n += 1
                except Exception as e:  # noqa: BLE001 — best-effort: a
                    # concurrent schema change must not end the walk.
                    if logger is not None:
                        logger.printf("preheat %s/%s failed: %s", iname, fname, e)
        self._preheat_programs(logger)
        return n

    def _preheat_programs(self, logger) -> None:
        """Load the kernel libraries, building those whose source changed,
        so the first request does not pay the load. This is all the port
        has to warm: the JAX package's counterpart compiles a TopN and pair
        programs for each resident stack shape, but these kernels take
        their shapes at run time, and launching them on the preheated
        stacks made the first TopN and pair request no faster on the card
        (PERF.md). Best-effort, as the stack walk."""
        if self.device.type != "cuda":
            return
        from pilosa_tpu_torch.ops.build import SOURCES, library

        try:
            for name in SOURCES:
                library(name)
            # Each mesh device's context, so no part's first launch makes
            # it; a kernel's shared-memory limit is set at its first launch
            # on a device (ops/csrc), which preheat does not make.
            for dev in dict.fromkeys(self.mesh.devices if self.mesh is not None else ()):
                torch.empty(0, device=dev)
        except Exception as e:  # noqa: BLE001
            if logger is not None:
                logger.printf("preheat kernel libraries failed: %s", e)

    # -- spec + leaf assembly ----------------------------------------------

    def _get_block(self, index, field_obj, shards, view_name=VIEW_STANDARD, min_rows=1):
        block, rows_p = self.blocks.get(index, field_obj, shards, view_name, min_rows)
        if block is None:
            raise _Unsupported("stack exceeds the device budget")
        return block, rows_p

    def _get_block_with_versions(self, index, field_obj, shards,
                                 view_name=VIEW_STANDARD, min_rows=1):
        """_get_block plus the per-shard (uid, version) the stack was packed
        from (None when its entry was replaced meanwhile)."""
        block, rows_p, vers = self.blocks.get_with_versions(
            index, field_obj, shards, view_name, min_rows)
        if block is None:
            raise _Unsupported("stack exceeds the device budget")
        return block, rows_p, vers

    def _field(self, index: str, name: str):
        idx = self.holder.index(index)
        f = idx.field(name) if idx else None
        if f is None:
            raise NotFoundError(f"field not found: {name}")
        return f

    # -- freshness: per-shard versions of the host tables -------------------

    def _count_version_walk(self, kind: str, tier: str, n_shards: int) -> None:
        """Count one freshness walk (kind: "full" or "journal") for a table
        tier, and the locked fragment reads it took: version_walk_total and
        version_walk_shards_total{kind, tier}, and the query's profile. A
        journal walk reads only the dirty shards."""
        st = self.stats.with_tags(f"kind:{kind}", f"tier:{tier}")
        st.count("version_walk_total")
        st.count("version_walk_shards_total", n_shards)
        prof = current_profile()
        prof.incr(f"version_walk_{kind}")
        prof.incr(f"version_walk_{kind}_shards", n_shards)
        ex = getattr(prof, "explain", None)
        if ex is not None:
            ex._node().setdefault("freshness", []).append(
                {"walk": kind, "tier": tier, "shards": n_shards})

    def _live_versions(self, field_obj, shards_t, view_name=VIEW_STANDARD,
                       tier="other"):
        """Per-shard (uid, version) of the live fragments, each read under
        its fr.lock (the full walk, one locked read a present fragment).
        Locked reads serialize with a writer, which makes _confirm_vers a
        true barrier after a capture."""
        v = field_obj.view(view_name)
        if v is None:
            self._count_version_walk("full", tier, 0)
            return tuple(None for _ in shards_t)
        out = []
        n_read = 0
        for s in shards_t:
            fr = v.fragment(s)
            n_read += fr is not None
            out.append(_locked_version(fr))
        self._count_version_walk("full", tier, n_read)
        return tuple(out)

    def _confirm_vers(self, field_obj, shards_t, recorded,
                      view_name=VIEW_STANDARD, tier="other"):
        """After a capture (a stack build and sweep that read content after
        reading versions): every shard whose live version moved past the
        recorded one is recorded as _VERS_STALE, so the next epoch
        re-derives it from its slab instead of replaying ops onto content
        that may already hold them."""
        live = self._live_versions(field_obj, shards_t, view_name, tier=tier)
        if live == recorded:
            return recorded
        return tuple(r if r == l else _VERS_STALE for r, l in zip(recorded, live))

    def _confirm_vers_journal(self, field_obj, shards_t, recorded, gen_recorded,
                              view_name=VIEW_STANDARD, tier="other"):
        """_confirm_vers in O(dirty) locked reads: a writer journals its
        shard before it bumps the fragment's version, in one critical
        section, so every write that could have staled a recorded version
        after generation gen_recorded is in the view's dirty_shards_since;
        the other shards' recorded versions are live. Falls back to the
        full walk when the journal cannot explain the window."""
        v = field_obj.view(view_name)
        if v is None:
            self._count_version_walk("journal", tier, 0)
            return tuple(None for _ in shards_t)
        dirty = v.dirty_shards_since(gen_recorded)
        if dirty is None:
            return self._confirm_vers(field_obj, shards_t, recorded, view_name, tier=tier)
        out = list(recorded)
        n_read = 0
        for i, s in enumerate(shards_t):
            if s not in dirty:
                continue
            fr = v.fragment(s)
            n_read += fr is not None
            if out[i] != _locked_version(fr):
                out[i] = _VERS_STALE
        self._count_version_walk("journal", tier, n_read)
        return tuple(out)

    def _epoch_versions(self, field_obj, shards_t, view_name, vers_old, gen_recorded,
                        tier="other"):
        """Per-shard live versions for an epoch update: when the view's
        journal explains (gen_recorded, now], only its dirty shards take a
        locked read and every other shard carries its recorded version
        forward (exact: an unjournaled shard was not mutated). Otherwise
        (no recorded versions, the journal evicted past gen_recorded, a
        fragment created or deleted) the full walk. A _VERS_STALE recorded
        by a racing capture heals here: the write that staled it bumped the
        generation after gen_recorded, so the journal names its shard."""
        v = field_obj.view(view_name)
        if v is None or vers_old is None:
            return self._live_versions(field_obj, shards_t, view_name, tier=tier)
        dirty = v.dirty_shards_since(gen_recorded)
        if dirty is None or len(vers_old) != len(shards_t):
            return self._live_versions(field_obj, shards_t, view_name, tier=tier)
        out = list(vers_old)
        n_read = 0
        for i, s in enumerate(shards_t):
            if s in dirty:
                fr = v.fragment(s)
                n_read += fr is not None
                out[i] = _locked_version(fr)
        self._count_version_walk("journal", tier, n_read)
        return tuple(out)

    def _build(self, index: str, c: Call, shards: tuple[int, ...],
               blocks: list, scalars: list):
        """One pass building (spec, device leaves). Raises _Unsupported for
        anything without a device lowering; callers route to the CPU
        oracle, which also produces the reference's error strings."""
        if c.name not in _DEVICE_LOWERED:
            raise _Unsupported(c.name)
        if c.name in ("Row", "Range"):
            return self._build_row(index, c, shards, blocks, scalars)
        if c.name == "All":
            if c.args:
                raise _Unsupported("All with args")
            self._push_existence(index, shards, blocks)
            return ("A",)
        if c.name == "Not":
            if len(c.children) != 1:
                raise _Unsupported("Not arity")
            self._push_existence(index, shards, blocks)
            child = self._build(index, c.children[0], shards, blocks, scalars)
            return ("N", child)
        if c.name == "Shift":
            n, _ = c.int_arg("n")
            if n < 0 or len(c.children) != 1:
                raise _Unsupported("Shift")
            child = self._build(index, c.children[0], shards, blocks, scalars)
            return ("S", n, child)
        if not c.children:
            raise _Unsupported("empty verb")  # the CPU path yields the reference's answer
        kids = tuple(
            self._build(index, ch, shards, blocks, scalars) for ch in c.children
        )
        return ({"Union": "U", "Intersect": "I", "Difference": "D", "Xor": "X"}[c.name], kids)

    def _push_existence(self, index: str, shards, blocks) -> None:
        idx = self.holder.index(index)
        ef = idx.existence_field() if idx else None
        if ef is None:
            raise _Unsupported("no existence field")
        block, _ = self._get_block(index, ef, shards)
        blocks.append(block)

    def _build_row(self, index, c, shards, blocks, scalars):
        cond_args = [(k, v) for k, v in c.args.items() if isinstance(v, Condition)]
        if cond_args:
            return self._build_bsi(index, c, shards, blocks, scalars, cond_args)
        field_name = c.field_arg()
        f = self._field(index, field_name)
        row_id, ok = c.uint64_arg(field_name)
        if not ok:
            raise QueryError("Row() must specify row")
        if "from" in c.args or "to" in c.args:
            return self._build_time_row(index, c, f, row_id, shards, blocks, scalars)
        try:
            block, rows_p = self._get_block(index, f, shards)
        except _Unsupported:
            # Row paging: the whole stack is over the byte budget, but one
            # row fits. Its [S, 1, W] page is an ordinary K11 leaf.
            blocks.append(self.blocks.get_row(index, f, shards, VIEW_STANDARD, row_id))
            scalars.append(0)
            scalars.append(1)
            return ("R", field_name)
        blocks.append(block)
        scalars.append(min(row_id, rows_p - 1))
        scalars.append(1 if row_id < rows_p else 0)
        return ("R", field_name)

    def _build_time_row(self, index, c, f, row_id, shards, blocks, scalars):
        """Row(f=r, from=, to=): the union over the quantum views
        (executor.go:1441)."""
        import datetime as dt

        if not f.options.time_quantum:
            # The reference returns empty for a non-time field with a range.
            self._push_bsi_or_field_block(index, f, shards, blocks)
            return ("E",)
        from_t = parse_time(c.args["from"]) if "from" in c.args else dt.datetime(1, 1, 1)
        to_t = (
            parse_time(c.args["to"])
            if "to" in c.args
            else dt.datetime.utcnow() + dt.timedelta(days=1)
        )
        views = [
            vn
            for vn in views_by_time_range(VIEW_STANDARD, from_t, to_t, f.options.time_quantum)
            if f.view(vn) is not None
        ]
        if not views:
            self._push_bsi_or_field_block(index, f, shards, blocks)
            return ("E",)
        for vn in views:
            block, rows_p = self._get_block(index, f, shards, view_name=vn)
            blocks.append(block)
            scalars.append(min(row_id, rows_p - 1))
            scalars.append(1 if row_id < rows_p else 0)
        return ("T", f.name, len(views))

    def _push_bsi_or_field_block(self, index, f, shards, blocks) -> None:
        """Push any block purely as a shape carrier for an ("E",) node."""
        block, _ = self._get_block(index, f, shards)
        blocks.append(block)

    def _build_bsi(self, index, c, shards, blocks, scalars, cond_args):
        """BSI condition -> resolved spec. Mirrors executeRowBSIGroupShard
        (executor.go:1533) and bsiGroup.baseValue (field.go:1584): the
        out-of-range and encompassing cases resolve here on the host, so
        the spec carries only (op, sign, depth) and the predicate bits."""
        if len(c.args) > 1:
            raise _Unsupported("Row(): too many arguments")
        field_name, cond = cond_args[0]
        f = self._field(index, field_name)
        if f.options.type != FIELD_TYPE_INT:
            raise _Unsupported("condition on non-int field")
        opts = f.bsi_group()
        depth = opts.bit_depth
        if depth > MAX_BSI_DEPTH:
            raise _Unsupported("bit depth")
        vname = bsi_view_name(field_name)

        def push_block():
            block, _ = self._get_block(
                index, f, shards, view_name=vname, min_rows=BSI_OFFSET_BIT + depth
            )
            blocks.append(block)

        if cond.op == NEQ and cond.value is None:
            push_block()
            return ("NN", field_name)

        if cond.op == BETWEEN:
            predicates = cond.int_slice_value()
            if len(predicates) != 2:
                raise QueryError(
                    "Row(): BETWEEN condition requires exactly two integer values"
                )
            lo, hi = predicates
            base_lo, base_hi, out_of_range = CPUBackend._base_value_between(f, lo, hi)
            push_block()
            if out_of_range:
                return ("E",)
            if lo <= opts.min and hi >= opts.max:
                return ("NN", field_name)
            if base_lo >= 0:
                cls = "pos"
            elif base_hi < 0:
                # The all-negative range: _eval_spec swaps the operands,
                # so (|lo|, |hi|) go in as they are.
                cls = "neg"
            else:
                cls = "mixed"
            scalars.append(_pred_bits(abs(base_lo), depth))
            scalars.append(_pred_bits(abs(base_hi), depth))
            return ("CB", field_name, cls, depth)

        if not isinstance(cond.value, int) or isinstance(cond.value, bool):
            raise QueryError("Row(): conditions only support integer values")
        value = cond.value
        base_value, out_of_range = CPUBackend._base_value(f, cond.op, value)
        push_block()
        if out_of_range and cond.op != NEQ:
            return ("E",)
        if (
            (cond.op == LT and value > opts.max)
            or (cond.op == LTE and value >= opts.max)
            or (cond.op == GT and value < opts.min)
            or (cond.op == GTE and value <= opts.min)
        ):
            return ("NN", field_name)
        if out_of_range and cond.op == NEQ:
            return ("NN", field_name)
        op = {EQ: "==", NEQ: "!=", LT: "<", LTE: "<", GT: ">", GTE: ">"}[cond.op]
        allow_eq = cond.op in (LTE, GTE)
        neg = base_value < 0
        scalars.append(_pred_bits(abs(base_value), depth))
        return ("C", field_name, op, neg, allow_eq, depth)

    def _assemble(self, index: str, c: Call, shards: tuple[int, ...]):
        blocks: list = []
        scalars: list = []
        spec = self._build(index, c, shards, blocks, scalars)
        return spec, tuple(blocks), tuple(scalars)

    # -- programs ------------------------------------------------------------

    def _count_program(self, spec, blocks, scalars) -> torch.Tensor:
        """Popcount of the evaluated tree: per-shard counts int32[S] (one
        K11 launch), summed on the device in int64, exact for any shard
        count."""
        return self._spec_run(spec_program(spec), blocks, [scalars], "count", "count",
                              "sum")[0]

    def _vec_program(self, spec, blocks, scalars):
        """The evaluated bitmap slab int32[S, W] (one K11 launch); under a
        mesh a Sharded of the parts' slabs."""
        return self._spec_run(spec_program(spec), blocks, [scalars], "slab", "vec", "slab")

    def _spec_run(self, prog, blocks, slots, mode: str, kind: str, out: str = "whole"):
        """K11 over one call group's blocks for each slot's scalars:
        int32[Q, S] per-shard counts ("count") or the slabs int32[Q, S, W]
        ("slab"), a mesh's parts gathered along the shard axis (out
        "whole") or left on their devices as a Sharded along axis 1 (out
        "parts"); or the counts summed over the shards, int64[Q], psum'd
        over the parts (out "sum"); or one slot's slab int32[S, W], a
        Sharded under a mesh (out "slab"). A program with slab leaves (a
        BSI condition, a Shift, a tree split past K11's limits) runs one
        slot a launch, since those leaves depend on the slot's scalars: its
        slab leaves are evaluated first for that slot (K10, _shift_slab,
        K11 in slab mode)."""
        key = (mode, prog.ops)
        n = len(prog.leaves)
        if out == "sum":
            merge = "psum"

            def body(b, sl):
                return self._spec_launch(prog, b, sl, mode).sum(dim=1, dtype=torch.int64)
        elif out == "slab":
            merge = None

            def body(b, sl):
                return self._spec_launch(prog, b, sl, mode)[0]
        else:
            merge = 1 if out == "whole" else None

            def body(b, sl):
                return self._spec_launch(prog, b, sl, mode)
        axis = 1 if out == "parts" else 0
        if prog.per_slot:
            args = (*blocks, _slots(1, n))
            outs = [
                self._launched(kind, key, args,
                               lambda sc=sc: self._run(body, (blocks, [sc]), merge, axis))
                for sc in slots
            ]
            if len(outs) == 1:
                return outs[0]
            if isinstance(outs[0], Sharded):
                return Sharded([torch.cat(ps) for ps in zip(*(o.parts for o in outs))],
                               outs[0].real, axis)
            return torch.cat(outs)
        return self._launched(kind, key, (*blocks, _slots(len(slots), n)),
                              lambda: self._run(body, (blocks, slots), merge, axis))

    def _spec_launch(self, prog, blocks, slots, mode: str) -> torch.Tensor:
        leaves = [self._spec_leaf(leaf, blocks, slots[0]) for leaf in prog.leaves]
        rows = [spec_leaf_rows(prog, scalars) for scalars in slots]
        return spec_eval(prog.ops, leaves, rows, mode)

    def _spec_leaf(self, leaf, blocks, scalars) -> torch.Tensor:
        """A program leaf's tensor: a stack of the call's blocks, or a slab
        leaf evaluated for one slot's scalars."""
        kind = leaf[0]
        if kind in ("row", "fixed", "zero"):
            return blocks[leaf[1]]
        if kind == "cmp":
            _, b, s, node = leaf
            if node[0] == "C":
                # ("C", field, op, neg_pred, allow_eq, depth): one K10 launch
                _, _fname, op, neg, allow_eq, depth = node
                return bsi_compare(blocks[b], depth, op, scalars[s], neg=neg,
                                   allow_eq=allow_eq)
            # ("CB", field, cls, depth), fragment.rangeBetween :1504
            _, _fname, cls, depth = node
            return bsi_compare(blocks[b], depth, cls, scalars[s], hi_bits=scalars[s + 1])
        if kind == "shift":
            return _shift_slab(self._spec_launch(leaf[2], blocks, [scalars], "slab")[0],
                               leaf[1]).contiguous()
        return self._spec_launch(leaf[1], blocks, [scalars], "slab")[0]  # "sub"

    # -- backend interface -------------------------------------------------

    def _held(self, index: str) -> tuple[int, ...]:
        """The index's shards that this node holds: its available shards,
        or in a cluster those of them that the topology gives this node.
        The same tuple object while neither moves (held_shards memoizes
        on the list's identity too)."""
        idx = self.holder.index(index)
        avail = idx.available_shards_list() if idx else []
        if self.held_shards is not None:
            return tuple(self.held_shards(index, avail))
        memo = self._held_memo.get(index)
        if memo is None or memo[0] is not avail:
            memo = self._held_memo[index] = (avail, tuple(avail))
        return memo[1]

    def _resident_candidates(self, index: str) -> list:
        """[(shard tuple, {shard: position})]: the tuples of the index's
        resident stacks (the most recently used first, when one was last
        stored or dropped), then the shards this node holds (_held). In a
        cluster a resident tuple is a candidate only while this node holds
        all its shards, so no stack is assembled over shards only peers
        hold. Memoized on the held tuple and blocks.version."""
        held = self._held(index)
        version = self.blocks.version  # before the walk: a racing store recomputes
        memo = self._resident_memo.get(index)
        if memo is not None and memo[0] is held and memo[1] == version:
            return memo[2]
        held_set = set(held)
        out: list = []
        for cand in self.blocks.resident_shard_sets(index) + [held]:
            if not cand or any(c == cand for c, _ in out):
                continue
            if self.held_shards is not None and not held_set.issuperset(cand):
                continue
            out.append((cand, {s: i for i, s in enumerate(cand)}))
        self._resident_memo[index] = (held, version, out)
        return out

    def _resident_shards(self, index: str, shards) -> tuple[tuple[int, ...], list[int]]:
        """(the shard tuple to assemble a call over ``shards`` against, each
        requested shard's position in it): the first of
        _resident_candidates that holds every requested shard, else the
        shards themselves. Per-shard calls and shard subsets thus reuse ONE
        resident stack a field instead of replacing it with packs of their
        own: a clustered coordinator folds its shards one call a shard, and
        a node's legs name its own subset of the index."""
        want = tuple(shards)
        for cand, pos in self._resident_candidates(index):
            if cand == want:
                return cand, list(range(len(want)))
            got = [pos.get(s) for s in want]
            if None not in got:
                return cand, got
        return want, list(range(len(want)))

    def _shard_call(self, index: str, c: Call, shard: int):
        """(program, the blocks narrowed to ``shard``'s slab, scalars) for a
        call over one shard, assembled against the resident shard tuple
        (_resident_shards): the launch reads only that shard's words.
        Raises _Unsupported as _assemble does."""
        shards_t, (pos,) = self._resident_shards(index, [shard])
        spec, blocks, scalars = self._assemble(index, c, shards_t)
        return spec, tuple(b.narrow(0, pos, 1) for b in blocks), scalars

    @staticmethod
    def _slab_row(host: np.ndarray, shards) -> Row:
        """uint32[R, W] host slab whose rows align with `shards` -> lazy
        columns-backed Row. Rows re-order (and dedupe) by shard first:
        Row.from_columns requires sorted-unique columns, and a caller's
        shard list may repeat a shard."""
        bases = np.asarray(shards, dtype=np.uint64) * np.uint64(SHARD_WIDTH)
        if bases.size > 1:
            uniq, first = np.unique(bases, return_index=True)
            if uniq.size != bases.size or not np.array_equal(uniq, bases):
                host = host[first]
                bases = uniq
        return Row.from_columns(unpack_slab_columns(host, bases))

    def _to_host_words(self, t: torch.Tensor) -> np.ndarray:
        return self._readback(t).view(np.uint32)

    def bitmap_call_shard(self, index: str, c: Call, shard: int) -> Row:
        try:
            spec, blocks, scalars = self._shard_call(index, c, shard)
        except _Unsupported:
            self._cpu_routed(c)
            return self.cpu.bitmap_call_shard(index, c, shard)
        slab = self._vec_program(spec, blocks, scalars)
        cols = unpack_row(self._to_host_words(slab[0])) + np.uint64(
            shard
        ) * np.uint64(SHARD_WIDTH)
        return Row.from_columns(cols)

    def bitmap_call(self, index: str, c: Call, shards: list[int]) -> Row:
        """Whole-query bitmap: evaluate the stack once, read back the
        requested shards' [S, W] words, unpack on the host."""
        shards_t, positions = self._resident_shards(index, shards)
        prof = current_profile()
        try:
            with prof.phase("plan"):
                spec, blocks, scalars = self._assemble(index, c, shards_t)
        except _Unsupported:
            self._cpu_routed(c)
            out = Row()
            for s in shards:
                out.merge(self.cpu.bitmap_call_shard(index, c, s))
            return out
        with trace_range("pilosa.bitmap_call"), prof.phase("device_dispatch"):
            slab = self._vec_program(spec, blocks, scalars)
            if isinstance(slab, Sharded):
                slab = slab.gather()
            if positions != list(range(slab.shape[0])):
                idx_t = torch.tensor(positions, dtype=torch.int64, device=slab.device)
                slab = torch.index_select(slab, 0, idx_t)
            host = self._to_host_words(slab)
        with prof.phase("host_reduce"):
            return self._slab_row(host, shards)

    def count_shard(self, index: str, c: Call, shard: int) -> int:
        """One shard's count: one K11 launch over that shard's slab of the
        resident stacks (_shard_call), so a clustered coordinator's fold
        over its shards neither repacks nor evicts a stack."""
        try:
            with current_profile().phase("plan"):
                spec, blocks, scalars = self._shard_call(index, c, shard)
        except _Unsupported:
            self._cpu_routed(c)
            return self.cpu.count_shard(index, c, shard)
        with current_profile().phase("device_dispatch"):
            count = int(self._count_program(spec, blocks, scalars))
        self.programs.block_ready()
        return count

    def count_shards(self, index: str, c: Call, shards: list[int]) -> int:
        """Whole-query count: one evaluation over all shards and one
        readback."""
        prof = current_profile()
        try:
            with prof.phase("plan"):
                spec, blocks, scalars = self._assemble(index, c, tuple(shards))
        except _Unsupported:
            self._cpu_routed(c)
            return sum(self.cpu.count_shard(index, c, s) for s in shards)
        with trace_range("pilosa.count"), prof.phase("device_dispatch"):
            total = self._count_program(spec, blocks, scalars)
            self.blocks.reuse.flush(self._REUSE_BATCH)  # while the card runs K11
            count = int(total)  # waits for K11
        self.programs.block_ready()
        return count

    def count_batch(self, index: str, calls: list[Call], shards: list[int]) -> list[int]:
        """Q count queries; see count_batch_async."""
        return self.count_batch_async(index, calls, shards)()

    def count_batch_async(
        self, index: str, calls: list[Call], shards: list[int]
    ) -> Callable[[], list[int]]:
        """Dispatch a batch of count queries and return a resolver: the
        device work is enqueued now, the resolver reads it back.

        When every call is a one- or two-row combination over one field
        pair, ONE pair-stats sweep serves the whole batch. Any other batch
        groups its calls by (spec, leaf blocks) and runs one K11 launch a
        group over the group's distinct slots (_generic_batch_dispatch).
        Only a size gate's refusal of the sweep (_Unsupported) sends a pair
        batch there: a kernel failure raises."""
        if not calls:
            return lambda: []
        shards_t = tuple(shards)
        plan = self._cached_pair_plan(index, calls)
        if plan is not None:
            try:
                return self._pair_batch_dispatch(index, plan, shards_t)
            except _Unsupported:
                pass  # a size gate refused the sweep; the K11 groups serve it
        return self._generic_batch_dispatch(index, calls, shards_t)

    def _group_calls(self, index, calls, shards_t):
        """Assemble each call and group the calls by (spec, leaf blocks):
        ({key: [call index]}, {call index: (blocks, scalars)}, [indices
        without a device lowering]). Blocks are cache-owned tensors, so
        their identity keys a group; the assembled tuples hold them, so no
        stack a group names is freed before its launch."""
        groups: dict = {}
        assembled: dict[int, tuple] = {}
        fallbacks: list[int] = []
        with current_profile().phase("plan"):
            for i, c in enumerate(calls):
                try:
                    spec, blocks, scalars = self._assemble(index, c, shards_t)
                except _Unsupported:
                    fallbacks.append(i)
                    continue
                key = (spec, tuple(id(b) for b in blocks))
                groups.setdefault(key, []).append(i)
                assembled[i] = (blocks, scalars)
        return groups, assembled, fallbacks

    @staticmethod
    def _distinct_slots(idxs, assembled):
        """(the distinct slots' scalars, call index -> slot): calls with the
        same scalars share one slot. A window of hot queries repeats the
        same trees, and K11's cost is per slot."""
        slot_index: dict = {}
        unique: list = []
        slot_of: dict[int, int] = {}
        for i in idxs:
            k = assembled[i][1]
            if k not in slot_index:
                slot_index[k] = len(unique)
                unique.append(k)
            slot_of[i] = slot_index[k]
        return unique, slot_of

    def _generic_batch_dispatch(self, index, calls, shards_t):
        """The counterpart of the JAX package's fused count_batch scans
        (pilosa_tpu/exec/tpu.py:4202): one K11 launch a (spec, blocks)
        group over exactly its distinct slots (a CUDA launch takes Q at run
        time, so there is no slot bucket and no lane mask), int64 sums on
        the card, one readback a group in the resolver."""
        prof = current_profile()
        groups, assembled, fallbacks = self._group_calls(index, calls, shards_t)
        pending = []  # (call indices, totals on the device, slot_of, blocks)
        for (spec, _bk), idxs in groups.items():
            blocks = assembled[idxs[0]][0]
            unique, slot_of = self._distinct_slots(idxs, assembled)
            with trace_range("pilosa.count_batch"), prof.phase("device_dispatch"):
                totals = self._spec_run(spec_program(spec), blocks, unique, "count",
                                        "count_batch", "sum")
            pending.append((idxs, totals, slot_of, blocks))

        def resolve() -> list[int]:
            results: list = [None] * len(calls)
            with current_profile().phase("device_dispatch"):
                hosts = [self._readback(totals) for _, totals, _, _ in pending]
            for (idxs, _, slot_of, _), host in zip(pending, hosts):
                for i in idxs:
                    results[i] = int(host[slot_of[i]])
            for i in fallbacks:
                results[i] = self.count_shards(index, calls[i], list(shards_t))
            return results

        return resolve

    def row_batch_async(
        self, index: str, calls: list[Call], shards: list[int]
    ) -> Callable[[], list[Row]]:
        """Batched bitmap materialization, the batcher's row legs (the JAX
        package's row_batch_async, pilosa_tpu/exec/tpu.py:4299): calls group
        by (spec, leaf blocks) over the resident stacks, identical slots
        dedupe, and each group's distinct slots run in K11's slab mode,
        chunked so that a launch's [Q, S, W] output stays under
        MAX_ROW_BATCH_BYTES. The resolver reads each launch back once
        (gathering a subset of the shards on the card first) and builds
        every call its own Row. Under a mesh each launch's output stays in
        its parts, each on its device within the budget, and the resolver
        reads each part back and joins them on the host. Calls without a
        device lowering take bitmap_call in the resolver."""
        shards_t, positions = self._resident_shards(index, shards)
        prof = current_profile()
        groups, assembled, fallbacks = self._group_calls(index, calls, shards_t)
        pending = []  # (call indices, slot_of, launch outputs, slots a launch, blocks)
        for (spec, _bk), idxs in groups.items():
            blocks = assembled[idxs[0]][0]
            unique, slot_of = self._distinct_slots(idxs, assembled)
            # A device's share: under a mesh each part's output holds its
            # own shards only (the JAX package's per-device budget).
            slab_bytes = (blocks[0].shape[0] // (self.mesh.n if self.mesh is not None else 1)
                          * WORDS_PER_SHARD * 4)
            # Rounded down to a power of two, as the JAX package's chunks.
            per_chunk = max(1, MAX_ROW_BATCH_BYTES // slab_bytes)
            per_chunk = 1 << (per_chunk.bit_length() - 1)
            prog = spec_program(spec)
            outs = []
            with trace_range("pilosa.row_batch"), prof.phase("device_dispatch"):
                for base in range(0, len(unique), per_chunk):
                    outs.append(self._spec_run(prog, blocks, unique[base : base + per_chunk],
                                               "slab", "vec_batch", "parts"))
            pending.append((idxs, slot_of, outs, per_chunk, blocks))
        whole = positions == list(range(len(shards_t)))
        pos_dev = None
        if pending and not whole and self.mesh is None:
            pos_dev = torch.tensor(positions, dtype=torch.int64, device=self.device)

        def host_words(out) -> np.ndarray:
            """A launch's [Q, S, W] words on the host, the requested
            shards' only."""
            if isinstance(out, Sharded):
                host = np.concatenate([self._to_host_words(p) for p in out.parts], axis=1)
                return host[:, : out.real] if whole else host[:, positions]
            return self._to_host_words(out if pos_dev is None
                                       else torch.index_select(out, 1, pos_dev))

        def resolve() -> list[Row]:
            results: list = [None] * len(calls)
            with current_profile().phase("device_dispatch"):
                hosts = [[host_words(out) for out in outs] for _, _, outs, _, _ in pending]
            with current_profile().phase("host_reduce"):
                for (idxs, slot_of, _, per_chunk, _), host in zip(pending, hosts):
                    for i in idxs:
                        slot = slot_of[i]
                        results[i] = self._slab_row(host[slot // per_chunk][slot % per_chunk],
                                                    shards)
            for i in fallbacks:
                results[i] = self.bitmap_call(index, calls[i], list(shards))
            return results

        return resolve

    # -- pair-stats batch path ---------------------------------------------

    def _plain_row_leaf(self, index: str, c: Call) -> Optional[tuple[str, int]]:
        """(field, row_id) when c is Row(field=intRow) on the standard view
        with nothing else going on; None otherwise."""
        if c.name != "Row" or c.children or len(c.args) != 1:
            return None
        try:
            fname = c.field_arg()
        except ValueError:
            return None
        v = c.args.get(fname)
        if isinstance(v, (Condition, bool)) or not isinstance(v, int) or v < 0:
            return None
        try:
            self._field(index, fname)
        except QueryError:
            return None  # let the per-call path raise the reference error
        return fname, v

    def _cached_pair_plan(self, index: str, calls: list[Call]):
        """Memoized _pair_batch_plan, keyed by the calls' identities plus
        the index's field set (creating a field re-plans)."""
        if not all(c.cached for c in calls):
            return self._pair_batch_plan(index, calls)
        idx = self.holder.index(index)
        fields_key = tuple(idx.fields) if idx is not None else ()
        key = (index, fields_key, tuple(map(id, calls)))
        with self._plan_lock:
            hit = self._plan_cache.get(key)
            if hit is not None:
                self._plan_cache[key] = self._plan_cache.pop(key)  # LRU
                return hit[0]
        plan = self._pair_batch_plan(index, calls)
        with self._plan_lock:
            self._plan_cache.pop(key, None)
            # The entry pins the calls, so their ids cannot be reused.
            self._plan_cache[key] = (plan, tuple(calls))
            while len(self._plan_cache) > 512:
                self._plan_cache.pop(next(iter(self._plan_cache)))
        return plan

    def _pair_batch_plan(self, index: str, calls: list[Call]):
        """Plan (entries, fa, fb) when the whole batch derives from the
        pair-count matrix + row-count vectors of one field pair. Entries
        are (op, row_a, row_b) with op 'A'/'B' for single-row counts on
        fa/fb and I/U/D/X for two-row verbs."""
        entries: list[tuple[str, int, int]] = []
        pair_fields: Optional[tuple[str, str]] = None
        singles: list[tuple[int, str, int]] = []  # (entry idx, field, row)
        for c in calls:
            leaf = self._plain_row_leaf(index, c)
            if leaf is not None:
                singles.append((len(entries), leaf[0], leaf[1]))
                entries.append(("A", leaf[1], 0))  # field side fixed below
                continue
            op = self._PAIR_VERBS.get(c.name)
            if op is None or len(c.children) != 2 or c.args:
                return None
            la = self._plain_row_leaf(index, c.children[0])
            lb = self._plain_row_leaf(index, c.children[1])
            if la is None or lb is None:
                return None
            if pair_fields is None:
                pair_fields = (la[0], lb[0])
            elif pair_fields != (la[0], lb[0]):
                return None
            entries.append((op, la[1], lb[1]))
        if pair_fields is None:
            if not singles:
                return None
            fa = singles[0][1]
            if any(f != fa for _, f, _ in singles):
                return None
            pair_fields = (fa, fa)
        fa, fb = pair_fields
        for i, f, row in singles:
            if f == fa:
                entries[i] = ("A", row, 0)
            elif f == fb:
                entries[i] = ("B", 0, row)
            else:
                return None
        return entries, fa, fb

    def _pair_program(self, fblock, gblock, pershard: bool) -> torch.Tensor:
        """One pair sweep: the per-shard table int32[S, D] (K1; under a mesh
        each part's rows gathered, the padding cut), or its sum over shards
        (K2, int32[D]; under a mesh each part's sum, psum'd in int64) past
        the retention gate."""
        args = (fblock, gblock)
        if pershard:
            return self._launched("pair_stats", "pair_stats_pershard", args,
                                  lambda: self._run(pair_stats_pershard, args, 0))
        return self._launched("pair_stats", "pair_stats", args,
                              lambda: self._run(pair_stats, args, "psum"))

    def _pair_batch_dispatch(self, index, plan, shards_t):
        entries, fa, fb = plan
        return functools.partial(self._pair_fetch, entries,
                                 self._pair_entry(index, fa, fb, shards_t))

    def _pair_entry(self, index, fa, fb, shards_t) -> _PairEntry:
        """The fresh pair entry of (fa, fb) over shards_t: a cache hit, an
        epoch absorbed on the host, or one sweep. Raises _Unsupported when
        a gate refuses the sweep."""
        f_obj = self._field(index, fa)
        g_obj = self._field(index, fb)
        ckey = (index, fa, fb)
        # Hit gate + single-flight admission: generations are read inside
        # the loop so a waiter re-checks against the freshest epoch.
        with current_profile().phase("freshness"):
            while True:
                gen_f, gen_g = self._generation(f_obj), self._generation(g_obj)
                with self._pair_lock:
                    hit = self._pair_cache.get(ckey)
                    if (
                        hit is not None
                        and hit.shards == shards_t
                        and hit.gen_f == gen_f
                        and hit.gen_g == gen_g
                    ):
                        self._pair_cache[ckey] = self._pair_cache.pop(ckey)  # LRU
                        self.stats.count("pair_stats_cache_hits_total")
                        return hit
                    latch = self._stats_updating.get(ckey)
                    if latch is None:
                        self._stats_updating[ckey] = threading.Event()
                        break
                latch.wait(timeout=60)
        try:
            return self._pair_refresh(
                index, fa, fb, f_obj, g_obj, shards_t, ckey, hit, gen_f, gen_g
            )
        finally:
            with self._pair_lock:
                ev = self._stats_updating.pop(ckey, None)
            if ev is not None:
                ev.set()

    def _pair_store(self, ckey, ent: _PairEntry) -> None:
        with self._pair_lock:
            self._pair_cache.pop(ckey, None)
            self._pair_cache[ckey] = ent
            while len(self._pair_cache) > MAX_PAIR_CACHE_ENTRIES:
                self._pair_cache.pop(next(iter(self._pair_cache)))

    def _pair_refresh(self, index, fa, fb, f_obj, g_obj,
                      shards_t, ckey, hit, gen_f, gen_g) -> _PairEntry:
        """The single-flight body, run without _pair_lock (the packing is
        the slow part; the latch makes this thread the only updater): the
        epoch's per-shard versions, then the host update when it can serve,
        else the stacks (built or spliced) and one sweep. The generations
        were read before the versions and the stacks, so an entry is never
        fresher than its key says (a racing write costs one more refresh,
        never a stale answer)."""
        prof = current_profile()
        hit_ok = hit is not None and hit.shards == shards_t
        with prof.phase("freshness"):
            vers_f = self._epoch_versions(
                f_obj, shards_t, VIEW_STANDARD, hit.vers_f if hit_ok else None,
                hit.gen_f if hit_ok else -1, tier="pair")
            vers_g = vers_f if fb == fa else self._epoch_versions(
                g_obj, shards_t, VIEW_STANDARD, hit.vers_g if hit_ok else None,
                hit.gen_g if hit_ok else -1, tier="pair")
            ent = self._pair_try_incremental(
                hit, f_obj, g_obj, shards_t, gen_f, gen_g, vers_f, vers_g)
        if ent is not None:
            self._pair_store(ckey, ent)
            return ent
        with prof.phase("stack_fetch"):
            fblock, _, bvers_f = self._get_block_with_versions(index, f_obj, shards_t)
            if fb == fa:
                gblock, bvers_g = fblock, bvers_f
            else:
                gblock, _, bvers_g = self._get_block_with_versions(index, g_obj, shards_t)
        rf, rg = fblock.shape[1], gblock.shape[1]
        reason, pershard_ok = self._pair_gates(fblock.shape[0], rf, rg)
        if reason is not None:
            raise _Unsupported(reason)
        # The stacks' versions describe what the sweep reads; the epoch's
        # live versions, read earlier, stand in when an entry was replaced.
        vers_f = bvers_f if bvers_f is not None else vers_f
        vers_g = bvers_g if bvers_g is not None else vers_g
        self.stats.count("pair_stats_sweeps_total")
        with trace_range("pilosa.pair_stats"), prof.phase("device_dispatch"):
            flat = self._pair_program(fblock, gblock, pershard_ok)
        # A shard that moved during the build or the sweep is recorded
        # _VERS_STALE: its swept content matches no version we could record.
        with prof.phase("freshness"):
            vers_f = self._confirm_vers(f_obj, shards_t, vers_f, tier="pair")
            vers_g = vers_f if fb == fa else self._confirm_vers(
                g_obj, shards_t, vers_g, tier="pair")
        ent = _PairEntry(shards_t, rf, rg, flat, None, gen_f, gen_g, vers_f, vers_g)
        self._pair_store(ckey, ent)
        return ent

    def _pair_gates(self, s_pad, rf, rg):
        """Size gates for a pair sweep. Returns (reject_reason_or_None,
        pershard_ok): pershard_ok keeps the per-shard table; otherwise the
        sweep sums on the device in int32, so tall summed sweeps are
        rejected outright."""
        if rf * rg > (1 << 16):
            return "pair matrix too large", False
        d_stats = rf * rg + rf + rg
        pershard_ok = s_pad * d_stats * 4 <= self.MAX_PAIR_PERSHARD_BYTES
        if not pershard_ok and s_pad > MAX_PAIR_SHARDS:
            return "pair sweep exceeds int32 shard bound", False
        return None, pershard_ok

    def _pair_try_incremental(self, hit, f_obj, g_obj, shards_t,
                              gen_f, gen_g, vers_f, vers_g) -> Optional[_PairEntry]:
        """Absorb a write epoch on the host, with no launch: each dirty
        shard's row of the previous entry's per-shard table is updated from
        its fragments' bit-op rings (_pair_shard_delta) or re-derived from
        host-packed slabs, and the totals re-summed. Returns the new entry,
        resolved already, or None when a sweep is needed: no per-shard
        table or versions, another shard set, more than
        MAX_PAIR_HOST_UPDATE_SHARDS slab shards, or a row past the table's
        height. hit.pershard is copied, never changed: an older entry may
        still be resolving on another thread. Recorded versions describe
        exactly the content captured: slab packs are confirmed
        (_pack_confirmed), delta shards keep the versions their op windows
        end at."""
        if (
            hit is None
            or hit.shards != shards_t
            or hit.pershard is None
            or hit.vers_f is None
            or hit.vers_g is None
        ):
            return None
        dirty = [i for i in range(len(shards_t))
                 if hit.vers_f[i] != vers_f[i] or hit.vers_g[i] != vers_g[i]]
        if not dirty:
            # The generation moved but no queried shard changed (a write
            # outside the shard set): re-key the same stats.
            return _PairEntry(shards_t, hit.rf, hit.rg, hit.stats, hit.pershard,
                              gen_f, gen_g, vers_f, vers_g)
        rf, rg = hit.rf, hit.rg
        fv = f_obj.view(VIEW_STANDARD)
        gv = g_obj.view(VIEW_STANDARD)
        pershard = hit.pershard.copy()
        vers_f_rec = list(vers_f)
        vers_g_rec = list(vers_g)
        slab_dirty: list[int] = []
        n_delta_ops = 0
        for i in dirty:
            ops = self._pair_shard_delta(hit, i, shards_t[i], fv, gv, f_obj is g_obj,
                                         pershard, vers_f, vers_g)
            if ops is None:
                slab_dirty.append(i)
            else:
                n_delta_ops += ops
        if len(slab_dirty) > self.MAX_PAIR_HOST_UPDATE_SHARDS:
            return None
        for i in slab_dirty:
            s = shards_t[i]
            fr = fv.fragment(s) if fv is not None else None
            if fr is None:
                fslab = np.zeros((rf, WORDS_PER_SHARD), dtype=np.uint32)
                vers_f_rec[i] = None
            else:
                fslab, vers_f_rec[i] = _pack_confirmed(fr, rf)
                if fr.max_row_id >= rf:
                    return None  # a row grew past the table's height: sweep
            if g_obj is f_obj:
                gslab, vers_g_rec[i] = fslab, vers_f_rec[i]
            else:
                gr = gv.fragment(s) if gv is not None else None
                if gr is None:
                    gslab = np.zeros((rg, WORDS_PER_SHARD), dtype=np.uint32)
                    vers_g_rec[i] = None
                else:
                    gslab, vers_g_rec[i] = _pack_confirmed(gr, rg)
                    if gr.max_row_id >= rg:
                        return None
            pershard[i] = _host_slab_pair_flat(fslab, gslab)
        totals = pershard.sum(axis=0, dtype=np.int64)
        self.stats.count("pair_stats_incremental_updates_total")
        self.stats.count("pair_stats_incremental_shards_total", len(dirty))
        if n_delta_ops:
            self.stats.count("pair_stats_delta_ops_total", n_delta_ops)
        return _PairEntry(shards_t, rf, rg, totals, pershard,
                          gen_f, gen_g, tuple(vers_f_rec), tuple(vers_g_rec))

    def _pair_shard_delta(self, hit, i, shard, fv, gv, self_pair,
                          pershard, vers_f, vers_g) -> Optional[int]:
        """Apply one dirty shard's epoch to pershard[i] (the flat row [pair
        | cf | cg]) as exact point-write deltas: each op of the changed
        side's bit-op ring is its row count +-1, plus membership probes
        against the unchanged side. Returns the number of ops applied, or
        None to hand the shard to the slab tier: a self pair, both sides
        changed, a recreated fragment (another uid), a fragment missing on
        either side since the walk, a ring that does not cover the window,
        or a row at or past the table's height (the row is reverted).

        _groupn_shard_delta applies the same probe, confirm and revert
        discipline to N fields: a fix to the version capture or the probe
        locking here must be made there too."""
        if self_pair:
            return None
        rf, rg = hit.rf, hit.rg
        ov_f, nv_f = hit.vers_f[i], vers_f[i]
        ov_g, nv_g = hit.vers_g[i], vers_g[i]
        f_changed = ov_f != nv_f
        if f_changed and ov_g != nv_g:
            return None
        if f_changed:
            ov, nv = ov_f, nv_f
            frag = fv.fragment(shard) if fv is not None else None
            other = gv.fragment(shard) if gv is not None else None
            n_rows, other_vers = rf, nv_g
        else:
            ov, nv = ov_g, nv_g
            frag = gv.fragment(shard) if gv is not None else None
            other = fv.fragment(shard) if fv is not None else None
            n_rows, other_vers = rg, nv_f
        if frag is None or ov is None or nv is None or ov[0] != nv[0]:
            return None  # created or recreated fragment: no op history
        ops = frag.bit_ops_between(ov[1], nv[1])
        if ops is None:
            return None
        # The probes read the other side's live storage, which the entry
        # records at its walk version: confirm it under its lock before and
        # after the probes. A write racing them would bake its bit into a
        # pair cell that the other side's own delta replays next epoch.
        if other is None:
            if other_vers is not None:
                return None  # fragment vanished since the walk
        elif other_vers is None or _locked_version(other) != other_vers:
            return None
        row_flat = pershard[i]
        sw = SHARD_WIDTH
        for _, r, c, sign in ops:
            if r >= n_rows:
                row_flat[:] = hit.pershard[i]
                return None  # the table's height is exceeded in the window
            if f_changed:
                row_flat[rf * rg + r] += sign  # cf[r]
                if other is not None:
                    base = r * rg
                    st = other.storage
                    for b in range(rg):
                        if st.contains(b * sw + c):
                            row_flat[base + b] += sign
            else:
                row_flat[rf * rg + rf + r] += sign  # cg[r]
                if other is not None:
                    st = other.storage
                    for a in range(rf):
                        if st.contains(a * sw + c):
                            row_flat[a * rg + r] += sign
        if other is not None and _locked_version(other) != other_vers:
            row_flat[:] = hit.pershard[i]
            return None
        return len(ops)

    def _pair_fetch(self, entries, ent) -> list[int]:
        """Derive the batch's counts from the entry's stats."""
        with current_profile().phase("host_reduce"):
            return self._pair_resolve(entries, self._pair_totals(ent), ent.rf, ent.rg)

    def _pair_totals(self, ent) -> np.ndarray:
        """The entry's int64 host totals [D]: the device table is read back
        on first touch and replaced by its totals; a per-shard table is kept
        beside them as ent.pershard."""
        stats = ent.stats
        if isinstance(stats, np.ndarray):
            return stats
        raw = self._readback(stats)  # ONE readback for all stats
        if raw.ndim == 2:
            pershard, totals = raw, raw.sum(axis=0, dtype=np.int64)
        else:
            pershard, totals = None, raw.astype(np.int64)
        with self._pair_lock:
            if ent.stats is stats:  # idempotent: racers read back too
                ent.stats = totals
                ent.pershard = pershard
        return totals

    @staticmethod
    def _pair_resolve(entries, stats_np, rf, rg) -> list[int]:
        p = stats_np[: rf * rg].reshape(rf, rg)
        f_ = stats_np[rf * rg : rf * rg + rf]
        g_ = stats_np[rf * rg + rf :]
        out = []
        for op, a, b in entries:
            ca = int(f_[a]) if a < rf else 0
            cb = int(g_[b]) if b < rg else 0
            pi = int(p[a, b]) if (a < rf and b < rg) else 0
            if op == "A":
                v = ca
            elif op == "B":
                v = cb
            elif op == "I":
                v = pi
            elif op == "U":
                v = ca + cb - pi
            elif op == "D":
                v = ca - pi
            else:  # X
                v = ca + cb - 2 * pi
            out.append(v)
        return out

    # -- TopN and Rows ---------------------------------------------------------

    def topn_field(self, index: str, field_name: str, shards: list[int], n: int,
                   src_call: Optional[Call] = None) -> Optional[list[Pair]]:
        """Exact TopN in one launch of K8: the per-row popcounts of the
        field's stack (ANDed with the src tree's slab when there is one),
        summed over shards on the card in int64; the counts vector reads
        back once; a field over the byte budget is swept a row page at a
        time. None when the src tree has no lowering: the executor's host
        iterator answers it and counts it."""
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx else None
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        if f.view(VIEW_STANDARD) is None:
            return []
        shards_t = tuple(shards)
        try:
            if src_call is None:
                counts = self._topn_counts(index, f, field_name, shards_t)
            else:
                src = self._assemble(index, src_call, shards_t)
                counts = self._topn_dispatch(index, f, shards_t, src, None, None)
        except _Unsupported:
            return None
        return self._topn_pairs(counts, n)

    def _topn_counts(self, index, f, field_name, shards_t) -> np.ndarray:
        """The unfiltered per-row counts vector, the host rank-vector table
        (the reference's rank cache, cache.go:136): keyed on the view's
        generation, so repeats serve without a launch; a write epoch that
        dirtied few shards updates the per-shard table on the host
        (_topn_try_incremental), any other re-dispatches. Single-flight:
        one refresher per field, waiters re-check. Serves TopN, unfiltered
        Rows and 1-field GroupBy. Entries: (cfp, counts, int64[S, R]
        per-shard table or None, per-shard versions)."""
        ckey = (index, field_name)
        ukey = ("topn", index, field_name)
        while True:
            cfp = (shards_t, self._generation(f))
            with self._pair_lock:
                hit = self._topn_cache.get(ckey)
                if hit is not None and hit[0] == cfp:
                    self._topn_cache[ckey] = self._topn_cache.pop(ckey)  # LRU
                    self.stats.count("topn_cache_hits_total")
                    return hit[1]
                latch = self._stats_updating.get(ukey)
                if latch is None:
                    self._stats_updating[ukey] = threading.Event()
                    break
            latch.wait(timeout=60)
        try:
            hit_ok = hit is not None and hit[3] is not None and hit[0][0] == shards_t
            with current_profile().phase("freshness"):
                live_vers = self._epoch_versions(
                    f, shards_t, VIEW_STANDARD, hit[3] if hit_ok else None,
                    hit[0][1] if hit_ok else -1, tier="topn")
                upd = self._topn_try_incremental(f, hit, shards_t, live_vers)
            if upd is not None:
                pershard, vers_rec = upd
                counts = pershard.sum(axis=0)
                self._topn_store(ckey, (cfp, counts, pershard, vers_rec))
                return counts
            return self._topn_dispatch(index, f, shards_t, None, ckey, cfp, live_vers)
        finally:
            with self._pair_lock:
                ev = self._stats_updating.pop(ukey, None)
            if ev is not None:
                ev.set()

    def _topn_store(self, ckey, entry) -> None:
        with self._pair_lock:
            self._topn_cache.pop(ckey, None)
            self._topn_cache[ckey] = entry
            while len(self._topn_cache) > MAX_PAIR_CACHE_ENTRIES:
                self._topn_cache.pop(next(iter(self._topn_cache)))

    def _topn_dispatch(self, index, f, shards_t, src, ckey, cfp,
                       live_vers=None) -> np.ndarray:
        """One K8 launch over the field's stack: int64[R] row counts, cached
        under ckey when given. Unfiltered, K8's [S, R] table is read back
        and kept when it passes the retention gate (_topn_pershard_ok), so
        later epochs update it on the host; otherwise it is summed on the
        card in int64. A stack over the byte budget is swept a row page at
        a time (_topn_paged_counts), and its counts are cached with no
        per-shard table, so a write epoch re-sweeps it. The generation in
        cfp was read before the stack, so a write racing the build costs a
        re-dispatch, never a stale answer."""
        prof = current_profile()
        with prof.phase("stack_fetch"):
            block, rows_p, vers = self.blocks.get_with_versions(index, f, shards_t)
        if vers is None:
            vers = live_vers  # the stack's entry was replaced: the earlier walk
        pershard = None
        with prof.phase("device_dispatch"):
            if block is None:
                # Each page is a range of its own (the JAX package's
                # pilosa.topn_page, outside its pilosa.topn).
                counts = self._topn_paged_counts(f, shards_t, src)
            else:
                with trace_range("pilosa.topn"):
                    masks = () if src is None else (self._filter_slab(src),)
                    args = (block, masks)
                    if src is None and self._topn_pershard_ok(block.shape[0], rows_p):
                        table = self._launched(
                            "topn", "row_popcounts", args,
                            lambda: self._run(lambda b, m: row_popcounts(b, 0, rows_p, m)[0],
                                              args, 0))
                        pershard = self._readback(table).astype(np.int64)
                        counts = pershard.sum(axis=0)
                    else:
                        counts = self._readback(self._launched(
                            "topn", "row_popcounts", args,
                            lambda: self._run(_row_counts_summed(rows_p), args, "psum")))
        if ckey is not None:
            # The launch read the stack after its versions: a shard that
            # moved meanwhile is recorded stale (_confirm_vers).
            vers = self._confirm_vers(f, shards_t, vers, tier="topn")
            self._topn_store(ckey, (cfp, counts, pershard, vers))
        return counts

    def _topn_page_rows(self, n_shards: int) -> int:
        """Row height of a paged TopN's page (the JAX package's rule): a
        quarter of the byte budget, floored at ROW_PAD. One page is in
        flight at a time, so the cache plus the page stay near 1.25 times
        the budget; the floor can take one page past the whole budget on a
        wide shard set."""
        bytes_per_row = n_shards * WORDS_PER_SHARD * 4
        budget = self.blocks.max_bytes or (1 << 30)
        return max(ROW_PAD, (budget // 4) // bytes_per_row // ROW_PAD * ROW_PAD)

    def _topn_paged_counts(self, f, shards_t, src) -> np.ndarray:
        """Per-row popcounts int64[n_rows] of a field too tall to be
        resident: fixed-height row pages packed on the host, copied to the
        card and counted by one K8 launch each (ANDed with the src tree's
        slab when there is one), summed over shards on the card and
        accumulated on the host in int64.

        Unlike the JAX package, which re-evaluates the src tree for every
        page (its topn_src program), the src tree is evaluated once and its
        slab is every page's mask: the same counts, one filter evaluation a
        request. K8 launches through raw pointers, so the page's tensor is
        referenced until the page's readback returns; the launch is on the
        stream the page was allocated on, which the caching allocator frees
        on."""
        v = f.view(VIEW_STANDARD)
        frags = {s: (v.fragment(s) if v is not None else None) for s in shards_t}
        n_rows = max([fr.max_row_id + 1 for fr in frags.values() if fr is not None] + [1])
        s_pad = self.blocks._pad_shards(len(shards_t))
        page = self._topn_page_rows(s_pad)
        masks = () if src is None else (self._filter_slab(src),)
        self.blocks.make_room(s_pad * page * WORDS_PER_SHARD * 4)
        counts = np.zeros(-(-n_rows // page) * page, dtype=np.int64)
        for start in range(0, n_rows, page):
            stop = min(start + page, n_rows)
            host = np.zeros((len(shards_t), page, WORDS_PER_SHARD), dtype=np.uint32)
            for i, s in enumerate(shards_t):
                fr = frags[s]
                if fr is not None and start <= fr.max_row_id:
                    host[i, : stop - start] = pack_rows(fr, start, stop)
            dev = self.blocks._put(host)
            global_stats.count("hbm_page_uploads_total")
            global_stats.count("hbm_page_bytes_total", dev.nbytes)  # padding included
            args = (dev, masks)
            with trace_range("pilosa.topn_page"):
                sums = self._launched("topn", "row_popcounts", args,
                                      lambda: self._run(_row_counts_summed(page), args, "psum"))
                counts[start : start + page] += self._readback(sums)
            del dev, sums  # after the readback: one page in flight
        return counts[:n_rows]

    def _topn_pershard_ok(self, s_pad: int, rows_p: int) -> bool:
        """The TopN table's retention gate (the JAX package's _topn_gates
        pershard_ok half): the int64 [S, R] host copy within
        MAX_PAIR_PERSHARD_BYTES."""
        return s_pad * rows_p * 8 <= self.MAX_PAIR_PERSHARD_BYTES

    def _topn_try_incremental(self, f, hit, shards_t, vers):
        """Absorb a write epoch into the TopN per-shard table on the host,
        with no launch: ops of a ring that covers the window are a row's
        count +-1, other dirty shards re-derive from version-confirmed
        slabs (_pack_confirmed). Returns (int64[S, R] table, recorded
        versions), or None when a dispatch is needed: no table or versions,
        another shard set, more than MAX_PAIR_HOST_UPDATE_SHARDS slab
        shards, or a row past the table's height. hit's table is copied,
        never changed."""
        if hit is None or hit[2] is None or hit[3] is None or hit[0][0] != shards_t:
            return None
        old_vers = hit[3]
        rp = hit[2].shape[1]
        dirty = [i for i in range(len(shards_t)) if old_vers[i] != vers[i]]
        if not dirty:
            # The generation moved by writes outside the queried shards:
            # the counts stand; re-key them.
            return hit[2], vers
        v = f.view(VIEW_STANDARD)
        pershard = hit[2].copy()
        vers_rec = list(vers)
        slab_dirty: list[int] = []
        for i in dirty:
            ov, nv = old_vers[i], vers[i]
            fr = v.fragment(shards_t[i]) if v is not None else None
            ops = None
            if fr is not None and ov is not None and nv is not None and ov[0] == nv[0]:
                ops = fr.bit_ops_between(ov[1], nv[1])
            if ops is None or any(r >= rp for _, r, _, _ in ops):
                slab_dirty.append(i)
                continue
            for _, r, _, sign in ops:
                pershard[i][r] += sign
        if len(slab_dirty) > self.MAX_PAIR_HOST_UPDATE_SHARDS:
            return None
        for i in slab_dirty:
            fr = v.fragment(shards_t[i]) if v is not None else None
            if fr is None:
                slab = np.zeros((rp, WORDS_PER_SHARD), dtype=np.uint32)
                vers_rec[i] = None
            else:
                slab, vers_rec[i] = _pack_confirmed(fr, rp)
                if fr.max_row_id >= rp:
                    return None  # a row grew past the table: re-dispatch
            pershard[i] = _host_slab_row_counts(slab)
        self.stats.count("topn_incremental_updates_total")
        self.stats.count("topn_incremental_shards_total", len(dirty))
        return pershard, tuple(vers_rec)

    @staticmethod
    def _topn_pairs(counts: np.ndarray, n: int) -> list[Pair]:
        order = np.lexsort((np.arange(counts.size), -counts.astype(np.int64)))
        pairs = [Pair(id=int(r), count=int(counts[r])) for r in order if counts[r] > 0]
        return pairs[:n] if n else pairs

    def rows_field(self, index: str, field_name: str, shards: list[int],
                   start: int = 0) -> Optional[list[int]]:
        """Unfiltered Rows(field) from the rank vector: a row with any bit
        has a nonzero count (empty containers are dropped on write), so the
        cached counts answer it in at most one launch instead of a host
        walk of every fragment (reference fragment.rows, fragment.go:2618).
        Row ids ascending, >= start."""
        pairs = self.topn_field(index, field_name, shards, 0, None)
        if pairs is None:
            return None
        return sorted(p.id for p in pairs if p.id >= start)

    # -- BSI aggregates (fragment.go:1111-1268) ------------------------------

    def _bsi_setup(self, index, field_name, shards, filter_call):
        """(field options, the filter's assembled (spec, blocks, scalars) or
        None, BSI stack [S, R, W])."""
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx else None
        if f is None:
            raise NotFoundError(f"field not found: {field_name}")
        if f.options.type != FIELD_TYPE_INT:
            raise _Unsupported("not an int field")
        opts = f.bsi_group()
        if opts.bit_depth > MAX_BSI_DEPTH:
            raise _Unsupported("bit depth")
        shards_t = tuple(shards)
        src = None
        if filter_call is not None:
            src = self._assemble(index, filter_call, shards_t)
        bsi_block, _ = self._get_block(
            index, f, shards_t, view_name=bsi_view_name(field_name),
            min_rows=BSI_OFFSET_BIT + opts.bit_depth,
        )
        return opts, src, bsi_block

    def _filter_slab(self, src):
        """The src tree's slab [S, W] (a Sharded under a mesh), or None."""
        if src is None:
            return None
        slab = self._vec_program(*src)
        return slab if isinstance(slab, Sharded) else slab.contiguous()

    def bsi_sum(self, index, field_name, shards, filter_call=None):
        """Sum(field): the planes' popcounts over the positive and the
        negative columns in one K8 launch (two masks), the considered
        columns' count by K3, weighted exactly on the host. Returns (sum,
        count), or None when the call cannot run on the card.

        Unfiltered, a write epoch is absorbed on the host when the BSI
        fragments' value-op rings explain it (_sum_try_incremental): the
        cached raw total and count move by the ops' exact deltas, with no
        launch. Filtered Sums are not cached."""
        # Fingerprint BEFORE the data snapshot: a write racing this query
        # must produce a never-matching cache entry, never a stale serve.
        hit = self._agg_lookup("sum", index, field_name, shards, filter_call)
        if hit is not None and hit[1] is not None:
            return hit[1]
        prof = current_profile()
        pre = None
        if hit is not None:
            with prof.phase("freshness"):
                upd = self._sum_try_incremental(index, field_name, shards, hit[0])
                if upd is not None:
                    return upd
                pre = self._agg_pre_versions(index, field_name, shards, "sum")
        try:
            with prof.phase("stack_fetch"):
                opts, src, bsi_block = self._bsi_setup(
                    index, field_name, shards, filter_call)
        except _Unsupported:
            return None
        depth = opts.bit_depth
        with trace_range("pilosa.bsi_sum"), prof.phase("device_dispatch"):
            filt = self._filter_slab(src)
            pos, neg, consider = self._run(_sum_masks, (bsi_block, filt))

            def sums(b, p, n, c):
                # [pos counts | neg counts | considered count], int64.
                planes = row_popcounts(b, BSI_OFFSET_BIT, depth, (p, n))
                return torch.cat([planes.sum(dim=1, dtype=torch.int64).reshape(-1),
                                  popcount_rows(c).sum(dtype=torch.int64).reshape(1)])

            args = (bsi_block, pos, neg, consider)
            totals = self._launched("bsi_sum", ("row_popcounts", "popcount_rows"), args,
                                    lambda: self._run(sums, args, "psum"))
            host = self._readback(totals)  # one readback
            pos_c, neg_c, count = host[:depth], host[depth:-1], int(host[-1])
        with prof.phase("host_reduce"):
            total = sum((int(pos_c[i]) - int(neg_c[i])) << i for i in range(depth))
        result = (total + opts.base * count, count)
        if hit is not None:
            extra = None
            if pre is not None:
                extra = (total, count, self._agg_confirm(pre, field_name, shards, "sum"))
            self._agg_store("sum", index, field_name, hit[0], result, extra)
        return result

    def _agg_pre_versions(self, index, field_name, shards, tier):
        """Before an aggregate's sweep: (field, the BSI view's per-shard
        versions by the full locked walk), None for a missing field. Read
        before the stack, so they are never newer than the content swept."""
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx else None
        if f is None:
            return None
        return f, self._live_versions(f, tuple(shards), bsi_view_name(field_name), tier=tier)

    def _agg_confirm(self, pre, field_name, shards, tier):
        """After an aggregate's sweep: the pre-sweep versions with every
        shard that moved since recorded _VERS_STALE (_confirm_vers), so a
        later epoch never replays ops onto content that already holds them."""
        f, vers = pre
        with current_profile().phase("freshness"):
            return self._confirm_vers(f, tuple(shards), vers, bsi_view_name(field_name),
                                      tier=tier)

    def _sum_try_incremental(self, index, field_name, shards, cfp_now):
        """Absorb a value-write epoch into the cached unfiltered Sum as
        exact deltas from the BSI fragments' value-op rings. Returns the
        fresh (sum, count), stored already, or None when the epoch is not
        explained by the rings (a bulk import_value, a ring overrun, a
        created or recreated fragment), the shard set changed, or the
        entry has no versions."""
        shards_t = tuple(shards)
        with self._pair_lock:
            ent = self._agg_cache.get(("sum", index, field_name))
        if ent is None or ent[2] is None:
            return None
        raw_total, count, vers_old = ent[2]
        if ent[0][0] != shards_t:
            return None
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx else None
        if f is None:
            return None
        vn = bsi_view_name(field_name)
        v = f.view(vn)
        vers_new = self._epoch_versions(f, shards_t, vn, vers_old, ent[0][1], tier="sum")
        d_sum = 0
        d_cnt = 0
        for i, s in enumerate(shards_t):
            ov, nv = vers_old[i], vers_new[i]
            if ov == nv:
                continue
            fr = v.fragment(s) if v is not None else None
            if fr is None or ov is None or nv is None or ov[0] != nv[0]:
                return None
            ops = fr.value_ops_between(ov[1], nv[1])
            if ops is None:
                return None
            for _, ook, ovv, nok, nvv in ops:
                d_sum += (nvv if nok else 0) - (ovv if ook else 0)
                d_cnt += (1 if nok else 0) - (1 if ook else 0)
        raw_total += d_sum
        count += d_cnt
        result = (raw_total + f.bsi_group().base * count, count)
        self._agg_store("sum", index, field_name, cfp_now, result,
                        (raw_total, count, vers_new))
        self.stats.count("sum_incremental_updates_total")
        return result

    def _agg_fingerprint(self, index, field_name, shards):
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx else None
        v = f.view(bsi_view_name(field_name)) if f is not None else None
        return (tuple(shards), v.generation if v is not None else -1)

    def _agg_lookup(self, kind, index, field_name, shards, filter_call):
        """(fingerprint, result) cache hit for an UNFILTERED aggregate,
        (fingerprint, None) for a miss, None for a filtered one (which
        depends on other fields' epochs). The fingerprint is captured
        BEFORE any sweep, so a write racing the compute can only produce a
        never-matching entry: pass it unchanged to _agg_store."""
        if filter_call is not None:
            return None
        cfp = self._agg_fingerprint(index, field_name, shards)
        key = (kind, index, field_name)
        with self._pair_lock:
            hit = self._agg_cache.get(key)
            if hit is not None and hit[0] == cfp:
                self._agg_cache[key] = self._agg_cache.pop(key)  # LRU
        if hit is not None and hit[0] == cfp:
            self.stats.count("agg_cache_hits_total")
            return hit
        return (cfp, None)

    def _agg_store(self, kind, index, field_name, cfp, result, extra=None) -> None:
        """Cache an unfiltered aggregate as (cfp, result, extra). extra is
        the state its host tier updates: Sum's (raw total, count,
        per-shard versions), Min's and Max's (per-shard (value, count)
        table, per-shard versions); None when there is none."""
        with self._pair_lock:
            self._agg_cache[(kind, index, field_name)] = (cfp, result, extra)
            while len(self._agg_cache) > MAX_PAIR_CACHE_ENTRIES:
                self._agg_cache.pop(next(iter(self._agg_cache)))
            self._agg_cache_charge()

    def bsi_min(self, index, field_name, shards, filter_call=None):
        return self._bsi_minmax("bsi_min", index, field_name, shards, filter_call)

    def bsi_max(self, index, field_name, shards, filter_call=None):
        return self._bsi_minmax("bsi_max", index, field_name, shards, filter_call)

    def _bsi_minmax(self, kind, index, field_name, shards, filter_call):
        """Per-shard Min/Max by plane narrowing in one K9 launch (both
        branches of every shard), then the host's reduce across shards
        with the executor's tie semantics. Returns (value, count), or None
        when the call cannot run on the card.

        Unfiltered, the per-shard (value, count) table is kept and absorbs
        a write epoch on the host (_minmax_try_incremental): a write that
        neither beats nor clears a shard's extremum changes nothing, a
        better value replaces it, and only a shard whose extremum was
        cleared is re-derived, by the fragment's own host walk
        (Fragment.min/max), with no launch."""
        hit = self._agg_lookup(kind, index, field_name, shards, filter_call)
        if hit is not None and hit[1] is not None:
            return hit[1]
        prof = current_profile()
        pre = None
        if hit is not None:
            with prof.phase("freshness"):
                upd = self._minmax_try_incremental(kind, index, field_name, shards, hit[0])
                if upd is not None:
                    return upd
                pre = self._agg_pre_versions(index, field_name, shards, "minmax")
        try:
            with prof.phase("stack_fetch"):
                opts, src, bsi_block = self._bsi_setup(
                    index, field_name, shards, filter_call)
        except _Unsupported:
            return None
        depth = opts.bit_depth
        with trace_range("pilosa.", kind), prof.phase("device_dispatch"):
            filt = self._filter_slab(src)
            which = "min" if kind == "bsi_min" else "max"
            args = (bsi_block, filt)
            table = self._launched(
                kind, "bsi_minmax", args,
                lambda: self._run(lambda b, fl: bsi_minmax(b, depth, fl, which), args, 1))
        with prof.phase("readback"):
            table = torch.from_numpy(self._readback(table))  # waits for K9
        bits_a, cnt_a, bits_b, cnt_b, branch_any, consider_any = (
            x.numpy() for x in split_minmax(table, depth))
        with prof.phase("host_reduce"):
            # Each branch's value from its decision bits, plane i's bit
            # weighing 2^i (depth <= 63: the magnitude fits in int64).
            weights = np.left_shift(np.int64(1), np.arange(depth, dtype=np.int64))
            mag_a = bits_a.astype(np.int64) @ weights
            mag_b = bits_b.astype(np.int64) @ weights
            if kind == "bsi_min":
                # Negatives exist: min = -maxUnsigned(neg); else minUnsigned.
                vals = np.where(branch_any, -mag_a, mag_b)
            else:
                # Positives exist: max = maxUnsigned(pos); else all negative,
                # max = -minUnsigned(consider).
                vals = np.where(branch_any, mag_a, -mag_b)
            cnts = np.where(branch_any, cnt_a, cnt_b).astype(np.int64)
            cnts[~consider_any] = 0
            # The per-shard table in Python ints: (value + base, count),
            # (0, 0) for a shard with no value.
            base = opts.base
            pershard = tuple((v + base, c) if c else (0, 0)
                             for v, c in zip(vals.tolist(), cnts.tolist()))
            result = self._minmax_reduce(kind, pershard)
        if hit is not None:
            extra = None
            if pre is not None:
                extra = (pershard, self._agg_confirm(pre, field_name, shards, "minmax"))
            self._agg_store(kind, index, field_name, hit[0], result, extra)
        return result

    @staticmethod
    def _minmax_reduce(kind, pershard) -> tuple[int, int]:
        """Cross-shard reduce of the per-shard (value, count) table with
        the executor's tie semantics: the extreme value over the shards
        with a count, the counts of every shard holding it summed; (0, 0)
        when none has one. Shared by the sweep and the host tier, so the
        two cannot drift apart."""
        best_val, best_cnt = 0, 0
        for val, cnt in pershard:
            if cnt == 0:
                continue
            if best_cnt == 0:
                best_val, best_cnt = val, cnt
            elif (kind == "bsi_min" and val < best_val) or (
                kind == "bsi_max" and val > best_val
            ):
                best_val, best_cnt = val, cnt
            elif val == best_val:
                best_cnt += cnt
        return best_val, best_cnt

    def _minmax_try_incremental(self, kind, index, field_name, shards, cfp_now):
        """Absorb a value-write epoch into the cached per-shard extremum
        table: O(1) updates for writes that cannot lower the extremum's
        standing; a shard whose extremum was cleared, whose table row is
        inconsistent with its ops, or whose ring does not cover the window
        is re-derived by the fragment's host plane walk under its lock,
        with no device work; a deleted fragment becomes (0, 0). Returns the
        fresh (value, count), stored already, or None when the entry must
        be swept again."""
        shards_t = tuple(shards)
        with self._pair_lock:
            ent = self._agg_cache.get((kind, index, field_name))
        if ent is None or ent[2] is None:
            return None
        pershard_old, vers_old = ent[2]
        if ent[0][0] != shards_t:
            return None
        idx = self.holder.index(index)
        f = idx.field(field_name) if idx else None
        if f is None or f.options.type != FIELD_TYPE_INT:
            return None
        bg = f.bsi_group()
        base, depth = bg.base, bg.bit_depth
        vn = bsi_view_name(field_name)
        v = f.view(vn)
        vers_new = self._epoch_versions(f, shards_t, vn, vers_old, ent[0][1], tier="minmax")
        better = (lambda a, b: a < b) if kind == "bsi_min" else (lambda a, b: a > b)
        pershard = list(pershard_old)
        vers_rec = list(vers_new)
        n_rederived = 0
        for i, s in enumerate(shards_t):
            ov, nv = vers_old[i], vers_new[i]
            if ov == nv:
                vers_rec[i] = ov
                continue
            fr = v.fragment(s) if v is not None else None
            if fr is None:
                pershard[i] = (0, 0)
                vers_rec[i] = None
                continue
            ops = None
            if ov is not None and nv is not None and ov[0] == nv[0]:
                ops = fr.value_ops_between(ov[1], nv[1])
            rederive = ops is None
            if not rederive:
                val, cnt = pershard[i]
                for _, ook, ovv, nok, nvv in ops:
                    if ook:
                        o = ovv + base
                        if cnt <= 0 or better(o, val):
                            rederive = True  # the table is inconsistent: rescan
                            break
                        if o == val:
                            cnt -= 1
                            if cnt == 0:
                                # The extremum was cleared: the next one is
                                # unknowable from the ops.
                                rederive = True
                                break
                    if nok:
                        nn = nvv + base
                        if cnt <= 0:
                            val, cnt = nn, 1
                        elif nn == val:
                            cnt += 1
                        elif better(nn, val):
                            val, cnt = nn, 1
                if not rederive:
                    pershard[i] = (val, cnt)
            if rederive:
                # The version is read under the lock the scan takes (an
                # RLock), so it describes exactly the scanned content.
                with fr.lock:
                    vv = (fr.uid, fr.version)
                    raw = fr.min(None, depth) if kind == "bsi_min" else fr.max(None, depth)
                pershard[i] = (raw[0] + base, raw[1]) if raw[1] else (0, 0)
                vers_rec[i] = vv
                n_rederived += 1
        result = self._minmax_reduce(kind, pershard)
        self._agg_store(kind, index, field_name, cfp_now, result,
                        (tuple(pershard), tuple(vers_rec)))
        self.stats.count("minmax_incremental_updates_total")
        if n_rederived:
            self.stats.count("minmax_shard_rederives_total", n_rederived)
        return result

    # -- GroupBy ---------------------------------------------------------------

    def group_by(self, index, c: Call, filter_call, child_rows, shards,
                 cap=None) -> Optional[list]:
        """Whole-query GroupBy: the group-count tensor over every shard on
        the card (one K3 or pair sweep for one or two fields, the tiled
        K4/K5 sweep over the live extra-row combinations for three or
        more), then the nonzero groups enumerated on the host in odometer
        order (reference groupByIterator, executor.go:3063), stopping at
        ``cap`` groups when the executor passes its limit+offset bound.
        Returns None when a gate refuses the query; the executor's host
        iterator then answers it, counted in cpu_routed_total{call}."""
        out = self._group_by(index, c, filter_call, child_rows, shards, cap)
        if out is None:
            self._cpu_routed(c)
        return out

    def _group_by(self, index, c, filter_call, child_rows, shards, cap):
        n = len(c.children)
        if n == 0 or n - 2 > MAX_GROUP_EXTRAS:
            return None  # the group kernels take at most MAX_GROUP_EXTRAS extras
        shards_t = tuple(shards)
        fields = []
        starts = []
        for child in c.children:
            if "from" in child.args or "to" in child.args:
                return None  # time-ranged Rows: the host unions quantum views
            fname = child.args.get("field") or child.args.get("_field")
            fields.append((fname, self._field(index, fname)))  # reference error
            prev, has_prev = child.uint64_arg("previous")
            starts.append(prev + 1 if has_prev else 0)
        # Unfiltered 1- and 2-field groups ARE the cached tables: the TopN
        # rank vector and the pair-count matrix.
        if filter_call is None and n <= 2:
            served = self._group_from_tables(index, fields, shards_t, n)
            if served is not None:
                stats_np, rs = served
                return self._group_enumerate(
                    fields, starts, child_rows, rs, stats_np, n, cap
                )
        # Unfiltered N>=3: the retained per-shard group tensor.
        if filter_call is None and n >= 3:
            served = self._groupn_tensor(index, fields, shards_t)
            if served is not None:
                stats_np, rs = served
                return self._group_enumerate(
                    fields, starts, child_rows, rs, stats_np, n, cap
                )
        # Group-tensor cache: the stats do not depend on candidate
        # restrictions (limit/column/previous act in the enumeration), so
        # the child views' generations key a reusable tensor. A filtered
        # tensor keys on the filter's canonical PQL too and fingerprints
        # the generations of every field the filter reads. The fingerprint
        # is taken BEFORE the stack fetch: a write racing this query must
        # make a never-matching entry, not a stale one.
        fkey = ffp = None
        if filter_call is not None:
            ffp = self._filter_epochs(index, filter_call)
            if ffp is not None:
                fkey = canonical_key(filter_call)
        ckey = cfp = None
        if filter_call is None or fkey is not None:
            ckey = ("groupby", index, tuple(f for f, _ in fields), fkey)
            cfp = (shards_t, tuple(self._generation(fo) for _, fo in fields), ffp)
        try:
            stacks = [self._get_block(index, fo, shards_t)[0] for _, fo in fields]
            filt = None
            if filter_call is not None:
                filt = self._filter_slab(self._assemble(index, filter_call, shards_t))
        except _Unsupported:
            return None
        if stacks[0].shape[0] > MAX_PAIR_SHARDS:
            return None  # int32 accumulator bound of the summed kernels
        rs = [int(st.shape[1]) for st in stacks]
        # The first two fields' row product is a dense [Rf, Rg] face in
        # every slot, so it keeps the pair sweep's bound; the extras'
        # product is bounded after pruning (MAX_GROUP_RESULT_CELLS).
        if n >= 2 and rs[0] * rs[1] > (1 << 16):
            return None
        if n <= 2 and _prod(rs) > (1 << 16):
            return None
        payload = None
        if ckey is not None:
            with self._pair_lock:
                hit = self._agg_cache.get(ckey)
                if hit is not None and hit[0] == cfp:
                    self._agg_cache[ckey] = self._agg_cache.pop(ckey)  # LRU
                    payload = hit[1]
            if payload is not None:
                self.stats.count("agg_cache_hits_total")
        if payload is None:
            with trace_range("pilosa.group_by"), current_profile().phase("device_dispatch"):
                if n >= 3:
                    payload = self._group_tiled_sweep(stacks, filt, rs)
                    if payload is None:
                        return None  # live product past the cell budget
                else:
                    payload = ("dense", self._group_dense(stacks, filt))
            if ckey is not None:
                with self._pair_lock:
                    self._agg_cache[ckey] = (cfp, payload)
                    while len(self._agg_cache) > MAX_PAIR_CACHE_ENTRIES:
                        self._agg_cache.pop(next(iter(self._agg_cache)))
                    self._agg_cache_charge()
        if payload[0] == "dense":
            return self._group_enumerate(
                fields, starts, child_rows, rs, payload[1], n, cap
            )
        _, live_rows, stats_live = payload
        return self._group_enumerate_live(
            fields, starts, child_rows, rs, live_rows, stats_live, n, cap
        )

    @staticmethod
    def _generation(field_obj) -> int:
        v = field_obj.view(VIEW_STANDARD)
        return v.generation if v is not None else -1

    def _filter_epochs(self, index, filter_call):
        """Epoch fingerprint of every field a GroupBy filter tree
        references: sorted (field, ((view, generation), ...)) tuples.
        None = uncacheable (a missing field, whose error the assemble path
        raises, or a time-ranged call, whose views depend on the clock)."""
        idx = self.holder.index(index)
        if idx is None:
            return None
        names = set()
        stack = [filter_call]
        while stack:
            call = stack.pop()
            if "from" in call.args or "to" in call.args:
                return None
            fn = call.args.get("field") or call.args.get("_field")
            if isinstance(fn, str):
                names.add(fn)
            for k, v in call.args.items():
                if isinstance(v, Call):
                    stack.append(v)
                elif not is_reserved_arg(k) and k != "field":
                    # Bitmap leaves spell the field as the arg KEY (Row(a=1),
                    # Row(v > 3)), so every non-reserved key names a field.
                    names.add(k)
            stack.extend(call.children)
        out = []
        for fn in sorted(names):
            f = idx.field(fn)
            if f is None:
                return None
            vs = tuple(sorted(
                (vn, f.view(vn).generation)
                for vn in list(f.views)
                if f.view(vn) is not None
            ))
            out.append((fn, vs))
        return tuple(out)

    def _agg_cache_charge(self) -> None:
        """Gauge of the host bytes the cached group tensors and aggregate
        payloads pin; called under _pair_lock after every store, so it
        tracks the LRU exactly. Entries are (cfp, payload) and (cfp,
        result, extra)."""
        total = 0
        for ent in self._agg_cache.values():
            for payload in ent[1:]:
                if isinstance(payload, tuple):
                    total += sum(p.nbytes for p in payload if isinstance(p, np.ndarray))
                elif isinstance(payload, np.ndarray):
                    total += payload.nbytes
        self.stats.gauge("agg_cache_bytes", total)

    def _group_from_tables(self, index, fields, shards_t, n):
        """(stats, rs) for an unfiltered 1- or 2-field GroupBy from the TopN
        rank vector or the pair-count matrix, or None when a table cannot
        serve (byte budget, size gates) and the tensor path should. Row
        counts stay under the tensor path's 2^16 bound."""
        if n == 1:
            f_obj = fields[0][1]
            v = f_obj.view(VIEW_STANDARD)
            if v is not None:
                # Bound-check BEFORE the rank vector: a tall field's sweep
                # would be thrown away here.
                max_row = max(
                    (fr.max_row_id for fr in (v.fragment(s) for s in shards_t)
                     if fr is not None),
                    default=0,
                )
                if max_row + 1 > (1 << 16):
                    return None
            try:
                counts = self._topn_counts(index, f_obj, fields[0][0], shards_t)
            except _Unsupported:
                return None
            if counts.size > (1 << 16):
                return None
            return counts.astype(np.int64), [counts.size]
        pm = self._pair_matrix(index, fields[0][0], fields[1][0], shards_t)
        if pm is None:
            return None
        matrix, rf, rg = pm
        return matrix, [rf, rg]

    def _pair_matrix(self, index, fa, fb, shards_t):
        """(int64[rf, rg] pair-count matrix, rf, rg) through the pair
        batch path's sweep and cache; None when a gate refuses the sweep."""
        try:
            ent = self._pair_entry(index, fa, fb, shards_t)
        except _Unsupported:
            return None
        totals = self._pair_totals(ent)
        return totals[: ent.rf * ent.rg].reshape(ent.rf, ent.rg), ent.rf, ent.rg

    def _group_dense(self, stacks, filt) -> np.ndarray:
        """The 1- or 2-field group tensor over the filtered first stack:
        int64[R] row counts (K3 over the [S*R, W] view, summed over shards
        on the card) or the int64[Rf, Rg] pair matrix (K2); psum'd over a
        mesh's parts."""
        def filtered(f, fl):
            return f if fl is None else f & fl[:, None, :]

        if len(stacks) == 1:
            args = (stacks[0], filt)
            counts = self._launched(
                "groupby", "popcount_rows", args,
                lambda: self._run(lambda f, fl: _stack_row_counts(filtered(f, fl)), args,
                                  "psum"))
            return self._readback(counts)
        rf, rg = stacks[0].shape[1], stacks[1].shape[1]
        args = (stacks[0], stacks[1], filt)
        flat = self._launched(
            "groupby", "pair_stats", args,
            lambda: self._run(lambda f, g, fl: pair_stats(filtered(f, fl), g), args, "psum"))
        return self._readback(flat[: rf * rg].reshape(rf, rg)).astype(np.int64)

    def _group_live_rows(self, stacks) -> list:
        """Per extra field, its live row ids: the rows with any bit in the
        swept stacks (K3 per-row popcounts, psum'd over a mesh's parts).
        Sound by construction: the counts come from the tensors every tile
        sweeps, so a pruned row is zero in every cell it would have
        produced."""
        out = []
        for st in stacks[2:]:
            counts = self._launched("groupby", "popcount_rows", (st,),
                                    lambda st=st: self._run(_stack_row_counts, (st,), "psum"))
            live = self._readback(counts) > 0
            out.append(np.nonzero(live)[0].astype(np.int32))
        return out

    def _prune(self, stacks):
        """(live_rows, combos): each extra field's live row ids, and every
        combination of them as int32[K_live, E] in odometer order (last
        extra fastest). A combination holding a globally empty row is zero
        in every cell, so only these are swept; the pruned ones are
        counted."""
        live_rows = self._group_live_rows(stacks)
        if any(len(lr) == 0 for lr in live_rows):
            combos = np.zeros((0, len(live_rows)), np.int32)
        else:
            grids = np.meshgrid(*live_rows, indexing="ij")
            combos = np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)
        pruned = _prod(st.shape[1] for st in stacks[2:]) - len(combos)
        if pruned:
            self.stats.count("groupby_pruned_groups_total", pruned)
        return live_rows, combos

    def _group_tiles(self, stacks, filt, combos, pershard: bool = False) -> np.ndarray:
        """Sweep every live combination, MAX_GROUP_TILE_SLOTS slots a
        launch (K4, or K5 per shard): int32[K_live, Rf, Rg] totals, or
        [K_live, S, Rf, Rg]. Every tile is enqueued before the first
        readback, so the card runs the tiles back to back."""
        f, g, extras = stacks[0], stacks[1], tuple(stacks[2:])
        rf, rg = int(f.shape[1]), int(g.shape[1])
        if len(combos) == 0:
            shape = (0, _real_shards(f), rf, rg) if pershard else (0, rf, rg)
            return np.zeros(shape, np.int32)
        kind = "group_tile_pershard" if pershard else "group_tile"
        pending = []
        for c0 in range(0, len(combos), MAX_GROUP_TILE_SLOTS):
            rows_idx = combos[c0 : c0 + MAX_GROUP_TILE_SLOTS]
            active = np.ones(len(rows_idx), np.int32)
            self.stats.count("groupby_tiles_total")
            self.stats.histogram("groupby_tile_occupancy", len(rows_idx))
            if pershard:
                # [T, S, Rf, Rg]: a mesh's parts gathered along the shards.
                args = (f, g, extras, rows_idx, active)
                pending.append(self._launched(
                    kind, "group_tile_stats_pershard", args,
                    lambda args=args: self._run(group_tile_stats_pershard, args, 1)))
            else:
                args = (f, g, extras, rows_idx, active, filt)
                pending.append(self._launched(
                    kind, "group_tile_stats", args,
                    lambda args=args: self._run(group_tile_stats, args, "psum")))
        return np.concatenate([self._readback(t) for t in pending])

    def _group_tiled_sweep(self, stacks, filt, rs):
        """Prune + tile + sweep the N>=3 group tensor: the ("live",
        live_rows, stats_live) payload, or None when the live combination
        product exceeds the host cell budget. live_rows holds each extra
        field's live row ids; stats_live is [K_live, Rf, Rg] in odometer
        order over them."""
        live_rows, combos = self._prune(stacks)
        if len(combos) * rs[0] * rs[1] > MAX_GROUP_RESULT_CELLS:
            return None
        stats_live = self._group_tiles(stacks, filt, combos)
        return (
            "live",
            tuple(tuple(int(r) for r in lr) for lr in live_rows),
            stats_live,
        )

    def _groupn_predicted_shapes(self, fobjs, shards_t):
        """The stack shapes a sweep of these fields will see, from the
        fragments' heights, without packing anything."""
        shapes = []
        for f in fobjs:
            v = f.view(VIEW_STANDARD)
            n_rows = 1
            if v is not None:
                n_rows = max(
                    [fr.max_row_id + 1
                     for fr in (v.fragment(sh) for sh in shards_t)
                     if fr is not None]
                    + [1]
                )
            shapes.append((self.blocks._pad_shards(len(shards_t)), _padded_rows(n_rows),
                           WORDS_PER_SHARD))
        return tuple(shapes)

    def _groupn_tensor(self, index, fields, shards_t):
        """(totals int64[K, rf, rg], rs) for an unfiltered N>=3 GroupBy from
        the retained per-shard table, or None when this path cannot serve
        (repeated field, size gates) and the generic tiled path should. A
        write epoch is absorbed on the host where it can be
        (_groupn_try_incremental: point writes as deltas against probes of
        the other fields, other dirty shards re-derived from host-packed
        slabs), with no launch; otherwise one K5 sweep derives the table
        again. Per field the epoch's versions come from the view's journal
        when the entry recorded them, else from the full locked walk.

        The JAX package also starts an ahead-of-time compile of the sweep
        here (its prewarm thread); the port's kernels are built once, not
        per shape, so there is nothing to start."""
        fobjs = [fo for _, fo in fields]
        if len({id(f) for f in fobjs}) != len(fobjs):
            return None  # repeated field: the delta's probe order is ambiguous
        ckey = ("groupn", index, tuple(fn for fn, _ in fields))
        views = [f.view(VIEW_STANDARD) for f in fobjs]
        while True:
            cfp = (shards_t, tuple(self._generation(f) for f in fobjs))
            with self._pair_lock:
                hit = self._groupn_cache.get(ckey)
                if hit is not None and hit.cfp == cfp:
                    self._groupn_cache[ckey] = self._groupn_cache.pop(ckey)  # LRU
                    self.stats.count("groupn_cache_hits_total")
                    return hit.stats, hit.rs
                latch = self._stats_updating.get(ckey)
                if latch is None:
                    self._stats_updating[ckey] = threading.Event()
                    break
            latch.wait(timeout=60)
        try:
            shapes = self._groupn_predicted_shapes(fobjs, shards_t)
            if shapes[0][0] * _prod(sh[1] for sh in shapes) * 4 > self.MAX_PAIR_PERSHARD_BYTES:
                # A table of this geometry could never be retained: refuse
                # before packing anything; the generic tiled path serves.
                return None
            hit_ok = hit is not None and hit.cfp[0] == shards_t and hit.vers is not None
            with current_profile().phase("freshness"):
                live = [
                    self._epoch_versions(
                        f, shards_t, VIEW_STANDARD, hit.vers[t] if hit_ok else None,
                        hit.cfp[1][t] if hit_ok else -1, tier="groupn")
                    for t, f in enumerate(fobjs)
                ]
                upd = self._groupn_try_incremental(hit, fobjs, views, shards_t, live)
            if upd is not None:
                pershard, vers_rec, rs, totals = upd
                if totals is None:
                    totals = pershard.sum(axis=0, dtype=np.int64).reshape(-1, rs[0], rs[1])
                self._groupn_store(ckey, _GroupNEntry(cfp, totals, pershard, rs, vers_rec))
                return totals, rs
            return self._groupn_dispatch(index, fobjs, shards_t, ckey, cfp, live)
        finally:
            with self._pair_lock:
                ev = self._stats_updating.pop(ckey, None)
            if ev is not None:
                ev.set()

    def _groupn_store(self, ckey, ent: _GroupNEntry) -> None:
        with self._pair_lock:
            self._groupn_cache.pop(ckey, None)
            self._groupn_cache[ckey] = ent
            while len(self._groupn_cache) > MAX_PAIR_CACHE_ENTRIES:
                self._groupn_cache.pop(next(iter(self._groupn_cache)))

    def _groupn_dispatch(self, index, fobjs, shards_t, ckey, cfp, live):
        """One K5 sweep of the live combinations, scattered into the dense
        per-shard table and stored with the versions it describes: the
        stacks' own (the epoch's walk where an entry was replaced),
        confirmed after the sweep through the views' journals
        (_confirm_vers_journal), a shard that moved recorded _VERS_STALE."""
        prof = current_profile()
        stacks, verss = [], []
        try:
            with prof.phase("stack_fetch"):
                for t, f in enumerate(fobjs):
                    block, _, vers = self._get_block_with_versions(index, f, shards_t)
                    stacks.append(block)
                    verss.append(vers if vers is not None else live[t])
        except _Unsupported:
            return None  # over the device budget: the generic path decides
        rs = [int(st.shape[1]) for st in stacks]
        k_total = _prod(rs[2:])
        face = rs[0] * rs[1]
        s_pad = int(stacks[0].shape[0])
        # K5's int32 accumulators bound the shards ONE launch sweeps: a
        # part's under a mesh (the JAX package's s_kernel).
        s_kernel = s_pad // (self.mesh.n if self.mesh is not None else 1)
        if s_kernel > MAX_PAIR_SHARDS or face > (1 << 16):
            return None
        if s_pad * k_total * face * 4 > self.MAX_PAIR_PERSHARD_BYTES:
            return None  # table too big to retain: the generic path sweeps
        s = len(shards_t)
        with trace_range("pilosa.groupn"), prof.phase("device_dispatch"):
            # The pruned slots of the dense table stay exactly zero.
            _, combos = self._prune(stacks)
            tiles = self._group_tiles(stacks, None, combos, pershard=True)
        with prof.phase("host_reduce"):
            # Scatter the live tiles [K_live, S, rf, rg] into the dense
            # table rows [S, K*rf*rg] at their odometer slots.
            pershard = np.zeros((s, k_total * face), np.int32)
            if len(combos):
                flat = None
                for t in range(combos.shape[1]):
                    col = combos[:, t].astype(np.int64)
                    flat = col if flat is None else flat * rs[2 + t] + col
                table = pershard.reshape(s, k_total, face)
                table[:, flat, :] = tiles.transpose(1, 0, 2, 3).reshape(s, len(combos), face)
            totals = pershard.sum(axis=0, dtype=np.int64).reshape(k_total, rs[0], rs[1])
        with prof.phase("freshness"):
            vers_rec = tuple(
                self._confirm_vers_journal(f, shards_t, verss[t], cfp[1][t], tier="groupn")
                for t, f in enumerate(fobjs)
            )
        self._groupn_store(ckey, _GroupNEntry(cfp, totals, pershard, rs, vers_rec))
        return totals, rs

    def _groupn_try_incremental(self, hit, fobjs, views, shards_t, live):
        """Absorb a write epoch into the N-field group table on the host,
        with no launch. Returns (int32[S, K*rf*rg] table, per-field
        recorded versions, rs, totals or None), totals being the cached ones
        when no queried shard changed (a write outside the shard set
        re-keys them), or None when a sweep is needed: no table or
        versions, another shard set, more than MAX_PAIR_HOST_UPDATE_SHARDS
        slab shards, a slab tier past MAX_GROUPN_HOST_SLAB_WORDS, or a row
        past the table's height. Delta shards record the versions their op
        windows end at; slab shards are packed with confirmed versions
        (_pack_confirmed), a deleted fragment as a zero slab with version
        None. hit.pershard is copied, never changed."""
        n = len(fobjs)
        if hit is None or hit.pershard is None or hit.cfp[0] != shards_t:
            return None
        rs = hit.rs
        rf, rg = rs[0], rs[1]
        k_total = _prod(rs[2:])
        dirty = [i for i in range(len(shards_t))
                 if any(hit.vers[t][i] != live[t][i] for t in range(n))]
        if not dirty:
            # A write outside the queried shards moved a generation: the
            # counts stand; re-key the cached totals.
            return hit.pershard, tuple(live), rs, hit.stats
        pershard = hit.pershard.copy()
        vers_rec = [list(lv) for lv in live]
        slab_dirty: list[int] = []
        n_delta_ops = 0
        for i in dirty:
            ops_applied = self._groupn_shard_delta(
                hit, i, shards_t[i], views, live, pershard, rs)
            if ops_applied is None:
                slab_dirty.append(i)
            else:
                n_delta_ops += ops_applied
        if len(slab_dirty) > self.MAX_PAIR_HOST_UPDATE_SHARDS:
            return None
        if len(slab_dirty) * k_total * rf * rg * WORDS_PER_SHARD > self.MAX_GROUPN_HOST_SLAB_WORDS:
            return None
        for i in slab_dirty:
            slabs = []
            for t in range(n):
                fr = views[t].fragment(shards_t[i]) if views[t] is not None else None
                if fr is None:
                    slabs.append(np.zeros((rs[t], WORDS_PER_SHARD), dtype=np.uint32))
                    vers_rec[t][i] = None
                else:
                    slab, vers_rec[t][i] = _pack_confirmed(fr, rs[t])
                    if fr.max_row_id >= rs[t]:
                        return None  # a row grew past the table: sweep
                    slabs.append(slab[: rs[t]])
            pershard[i] = _host_slab_groupn(slabs, rs)
        self.stats.count("groupn_incremental_updates_total")
        self.stats.count("groupn_incremental_shards_total", len(dirty))
        if n_delta_ops:
            self.stats.count("groupn_delta_ops_total", n_delta_ops)
        return pershard, tuple(tuple(v) for v in vers_rec), rs, None

    def _groupn_shard_delta(self, hit, i, shard, views, live, pershard, rs) -> Optional[int]:
        """Apply one dirty shard's epoch to pershard[i] as exact point-write
        deltas: each op of the changed field's bit-op ring is +-1 in every
        cell whose other fields' rows hold the op's column, found by probing
        their storage. Returns the number of ops applied, or None to hand
        the shard to the slab tier: more than one field changed (probes of
        a changing peer are ambiguous), a recreated fragment, a ring that
        does not cover the window, a probed fragment that moved, or a row
        at or past the table's height (the row is reverted).

        The same discipline as _pair_shard_delta's probe, confirm and
        revert, for N fields: a fix to the version capture or the probe
        locking in either method must be made in the other too. They stay
        apart as in the JAX package, where the pair tier carries the
        batcher's and the device stack's coupling that this tier avoids."""
        n = len(views)
        changed = [t for t in range(n) if hit.vers[t][i] != live[t][i]]
        if len(changed) != 1:
            return None
        t = changed[0]
        ov, nv = hit.vers[t][i], live[t][i]
        frag = views[t].fragment(shard) if views[t] is not None else None
        if frag is None or ov is None or nv is None or ov[0] != nv[0]:
            return None
        ops = frag.bit_ops_between(ov[1], nv[1])
        if ops is None:
            return None
        # The probes read the other fields' live storage, which the entry
        # records at their walk versions: confirm each under its lock before
        # and after the probes. A write racing them would bake its bit into
        # a cell that the field's own delta replays next epoch.
        others = []
        for u in range(n):
            if u == t:
                continue
            fru = views[u].fragment(shard) if views[u] is not None else None
            if fru is None:
                if live[u][i] is not None:
                    return None  # the fragment vanished since the walk
            elif live[u][i] is None or _locked_version(fru) != live[u][i]:
                return None
            others.append((u, fru))
        sw = SHARD_WIDTH
        row_flat = pershard[i]
        extra_rs = rs[2:]
        for _, r, c, sign in ops:
            if r >= rs[t]:
                row_flat[:] = hit.pershard[i]
                return None  # the table's height is exceeded in the window
            row_sets = [None] * n
            row_sets[t] = (r,)
            empty = False
            for u, fru in others:
                if fru is None:
                    empty = True
                    break
                st = fru.storage
                rows_u = tuple(b for b in range(rs[u]) if st.contains(b * sw + c))
                if not rows_u:
                    empty = True
                    break
                row_sets[u] = rows_u
            if empty:
                continue  # some field has no bit at c: no cell changes
            for combo in itertools.product(*row_sets):
                k = 0
                for tt in range(2, n):
                    k = k * extra_rs[tt - 2] + combo[tt]
                row_flat[(k * rs[0] + combo[0]) * rs[1] + combo[1]] += sign
        for u, fru in others:
            if fru is not None and _locked_version(fru) != live[u][i]:
                row_flat[:] = hit.pershard[i]
                return None
        return len(ops)

    @staticmethod
    def _group_candidates(starts, child_rows, rs, n) -> list:
        cand = []
        for i in range(n):
            if child_rows[i] is not None:
                cand.append([r for r in child_rows[i] if r >= starts[i]])
            else:
                cand.append(list(range(starts[i], rs[i])))
        return cand

    def _group_enumerate(self, fields, starts, child_rows, rs, stats_np, n,
                         cap=None) -> list:
        """Candidate enumeration over the dense group stats, in the
        reference groupByIterator's order. Stops after ``cap`` nonzero
        groups when set: the executor's limit+offset window is a prefix of
        the odometer order, so the early exit is exact."""
        cand = self._group_candidates(starts, child_rows, rs, n)
        out = []
        full = cap if cap is not None else float("inf")
        if n == 1:
            for a in cand[0]:
                v = int(stats_np[a]) if a < rs[0] else 0
                if v > 0:
                    out.append(GroupCount([FieldRow(fields[0][0], a)], v))
                    if len(out) >= full:
                        return out
        elif n == 2:
            for a in cand[0]:
                for b in cand[1]:
                    v = int(stats_np[a, b]) if (a < rs[0] and b < rs[1]) else 0
                    if v > 0:
                        out.append(GroupCount(
                            [FieldRow(fields[0][0], a), FieldRow(fields[1][0], b)], v
                        ))
                        if len(out) >= full:
                            return out
        else:
            # The tensor's k axis runs over fields 3..n (last fastest), while
            # enumeration follows child order (first field outermost), as
            # the reference groupByIterator does.
            extra_rs = rs[2:]
            for a in cand[0]:
                for b in cand[1]:
                    if not (a < rs[0] and b < rs[1]):
                        continue
                    for extra in itertools.product(*cand[2:]):
                        if any(e >= extra_rs[t] for t, e in enumerate(extra)):
                            continue
                        k = 0
                        for t, e in enumerate(extra):
                            k = k * extra_rs[t] + e
                        v = int(stats_np[k, a, b])
                        if v > 0:
                            out.append(GroupCount(
                                [FieldRow(fields[0][0], a), FieldRow(fields[1][0], b)]
                                + [FieldRow(fields[2 + t][0], e)
                                   for t, e in enumerate(extra)],
                                v,
                            ))
                            if len(out) >= full:
                                return out
        return out

    def _group_enumerate_live(self, fields, starts, child_rows, rs,
                              live_rows, stats_live, n, cap=None) -> list:
        """Streamed enumeration over the PRUNED group tensor [K_live, Rf,
        Rg]: nonzero extraction per (a-row x combination) slice in
        enumeration order (first field outermost, the extras' odometer
        innermost), so the dense product tensor never materialises on the
        host and a ``cap`` exits after the first slices that fill it.
        Pruned combinations held a globally empty row, so their count is
        zero and the reference iterator skips them too."""
        cand = self._group_candidates(starts, child_rows, rs, n)
        cand_a = [a for a in cand[0] if a < rs[0]]
        cand_b = np.asarray([b for b in cand[1] if b < rs[1]], dtype=np.int64)
        # Per extra field: the candidate rows that are live, with their
        # position in the live row list (the tiles run over live-list
        # POSITIONS; enumeration keeps CANDIDATE order).
        dims = [len(lr) for lr in live_rows]
        pos_lists = []
        row_lists = []
        for t in range(n - 2):
            lookup = {int(r): p for p, r in enumerate(live_rows[t])}
            keep = [(lookup[r], r) for r in cand[2 + t]
                    if r < rs[2 + t] and r in lookup]
            pos_lists.append(np.asarray([p for p, _ in keep], dtype=np.int64))
            row_lists.append(np.asarray([r for _, r in keep], dtype=np.int64))
        if (not cand_a or cand_b.size == 0
                or any(p.size == 0 for p in pos_lists) or stats_live.shape[0] == 0):
            return []
        grids = np.meshgrid(*pos_lists, indexing="ij")
        flat = None
        for t, gpos in enumerate(grids):
            flat = gpos if flat is None else flat * dims[t] + gpos
        flat = flat.ravel()
        extra_rows = [g.ravel() for g in np.meshgrid(*row_lists, indexing="ij")]
        sel = stats_live[flat]  # [M, Rf, Rg], bounded by the live tensor
        out = []
        full = cap if cap is not None else float("inf")
        fname_a, fname_b = fields[0][0], fields[1][0]
        enames = [fields[2 + t][0] for t in range(n - 2)]
        for a in cand_a:
            # [B, M] for this a-row: nonzero walks b-major, then combination.
            arr = sel[:, a][:, cand_b].T
            bi, mi = np.nonzero(arr)
            vals = arr[bi, mi]
            for j in range(bi.size):
                m = int(mi[j])
                frs = [FieldRow(fname_a, int(a)), FieldRow(fname_b, int(cand_b[bi[j]]))]
                frs.extend(FieldRow(enames[t], int(extra_rows[t][m]))
                           for t in range(n - 2))
                out.append(GroupCount(frs, int(vals[j])))
                if len(out) >= full:
                    return out
        return out
