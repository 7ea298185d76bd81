"""CUDA device backend: PQL bitmap calls on device-resident shard stacks.

The counterpart of the JAX package's TPUBackend, for Count and Row queries:

- Per (index, field, view) the backend keeps a stacked int32[S, R_pad, W]
  tensor on the device (the bits of the host's uint32 pack), rebuilt when
  the view's generation moves. A write epoch that dirtied few shards
  re-packs only those shards and splices them into the resident stack in
  place (``index_copy_``).
- A Count or Row call tree becomes torch bitwise ops over [S, W] slabs:
  ``index_select`` gathers the rows, then ``&``, ``|``, ``^`` and ``~``.
  The per-shard popcount is the hand-written kernel K3
  (ops/kernels.py popcount_rows).
- A request of several Counts over one field pair is planned onto one sweep
  of K1 (pair_stats_pershard), or of K2 (pair_stats) when the per-shard
  table is too big to keep; the host derives every verb from the pair
  matrix and the row counts.
- GroupBy computes its group-count tensor on the card and enumerates the
  nonzero groups on the host: one field through K3, two through the pair
  kernels, three or more through the group-tile kernels K4/K5 over the
  extra fields' live row combinations (ops/kernels.py).

Calls without a device lowering here (BSI conditions, time ranges, Shift)
raise _Unsupported while their tree is assembled and are answered by the
CPU oracle, counted in ``cpu_routed_total{call}``. Kernel failures are not
caught: they raise to the caller.
"""

from __future__ import annotations

import functools
import itertools
import threading
from typing import Callable, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec.cpu import CPUBackend, NotFoundError, QueryError
from pilosa_tpu_torch.exec.result import FieldRow, GroupCount
from pilosa_tpu_torch.ops.blocks import (
    WORDS_PER_SHARD,
    _padded_rows,
    pack_fragment,
    unpack_row,
    unpack_slab_columns,
)
from pilosa_tpu_torch.ops.kernels import (
    MAX_GROUP_EXTRAS,
    MAX_GROUP_TILE_SLOTS,
    MAX_PAIR_SHARDS,
    group_tile_stats,
    group_tile_stats_pershard,
    pair_stats,
    pair_stats_pershard,
    popcount_rows,
)
from pilosa_tpu_torch.pql.ast import Call, Condition, canonical_key, is_reserved_arg
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.locks import InstrumentedRLock
from pilosa_tpu_torch.utils.qprofile import current_profile
from pilosa_tpu_torch.utils.stats import global_stats

_DEVICE_LOWERED = ("Row", "Range", "Union", "Intersect", "Difference", "Xor", "Not", "All")

# Pair-stats host cache bound: entries may hold in-flight device tables, so
# the LRU cap keeps many-field indexes from pinning device memory.
MAX_PAIR_CACHE_ENTRIES = 16

# Host-side cap on one GroupBy result tensor's cells (live_K * Rf * Rg).
# Bounds the aggregate-cache charge and the enumeration working set;
# combinations past it go to the CPU oracle rather than exhausting the host.
MAX_GROUP_RESULT_CELLS = 1 << 24


class _Unsupported(Exception):
    """Raised by the spec builder when a call can't be device-lowered."""


class _StackedBlocks:
    """Device cache: (index, field, view) -> int32[S, R_pad, W] + freshness.

    An optional byte budget LRU-evicts whole stacks; a stack that can never
    fit is not cached and its callers route to the CPU oracle."""

    #: Incremental-update cutoff: splice at most 1/2 of the shard axis
    #: before a full repack wins.
    MAX_INCREMENTAL_FRACTION = 2

    #: Dirty slabs are packed and copied in chunks of this many shards, so
    #: the host staging buffer stays small for any dirty count.
    UPDATE_CHUNK = 8

    def __init__(self, device: torch.device, max_bytes: Optional[int] = None):
        self.device = device
        self.max_bytes = max_bytes
        # key -> (fingerprint, device tensor, rows_p, per-shard versions).
        self._entries: dict[tuple, tuple[tuple, torch.Tensor, int, Optional[tuple]]] = {}
        self.evictions = 0
        self._lock = InstrumentedRLock("device_stacks")
        # Per-key build latch: concurrent misses for one stack build it once.
        self._building: dict[tuple, threading.Event] = {}

    def _put(self, host: np.ndarray) -> torch.Tensor:
        """uint32 host words -> int32 tensor with the same bits on the device."""
        return torch.from_numpy(host.view(np.int32)).to(self.device)

    def get(self, index: str, field_obj, shards: tuple[int, ...],
            view_name: str = VIEW_STANDARD, min_rows: int = 1):
        """Returns (stack [S, R_pad, W], rows_p), or (None, rows_p) when the
        stack cannot be resident under the byte budget. Missing fragments
        pack as zeros."""
        v = field_obj.view(view_name)
        # O(1) freshness: the view's generation covers every fragment
        # mutation and create/delete under it.
        fingerprint = (tuple(shards), v.generation if v is not None else -1, min_rows)
        key = (index, field_obj.name, view_name)

        def build(stale):
            frags = {s: (v.fragment(s) if v is not None else None) for s in shards}
            vers = tuple(
                (fr.uid, fr.version) if fr is not None else None
                for fr in (frags[s] for s in shards)
            )
            n_rows = max(
                [fr.max_row_id + 1 for fr in frags.values() if fr is not None]
                + [min_rows]
            )
            rows_p = _padded_rows(n_rows)
            updated = self._try_incremental(stale, shards, min_rows, frags, vers, rows_p)
            if updated is not None:
                return updated, rows_p, vers
            shape = (len(shards), rows_p, WORDS_PER_SHARD)
            nbytes = shape[0] * rows_p * WORDS_PER_SHARD * 4
            if self.max_bytes is not None and nbytes > self.max_bytes:
                return None, rows_p, vers
            if stale is not None:
                global_stats.count("stack_full_rebuilds_total")
            # Drop the stale stack before allocating its successor, so a
            # rebuild never holds two copies on the device.
            with self._lock:
                self._entries.pop(key, None)
            host = np.zeros(shape, dtype=np.uint32)
            for i, s in enumerate(shards):
                fr = frags[s]
                if fr is not None:
                    host[i] = pack_fragment(fr, n_rows=rows_p)
            return self._put(host), rows_p, vers

        return self._cached_build(key, fingerprint, build)

    def _try_incremental(self, stale, shards, min_rows, frags, vers, rows_p):
        """Dirty-shard refresh: when a write epoch touched few shards of a
        resident stack of the same geometry, re-pack just those shard slabs
        and copy them into the stack in place. Returns the updated stack,
        or None when a full rebuild is needed.

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
        if not dirty or len(dirty) > max(1, len(shards) // self.MAX_INCREMENTAL_FRACTION):
            return None
        for c0 in range(0, len(dirty), self.UPDATE_CHUNK):
            chunk = dirty[c0 : c0 + self.UPDATE_CHUNK]
            slabs = np.zeros((len(chunk), rows_p, WORDS_PER_SHARD), dtype=np.uint32)
            for j, i in enumerate(chunk):
                fr = frags[shards[i]]
                if fr is not None:
                    slabs[j] = pack_fragment(fr, n_rows=rows_p)
            idx = torch.tensor(chunk, dtype=torch.int64, device=self.device)
            old_arr.index_copy_(0, idx, self._put(slabs))
            global_stats.count("stack_update_bytes_total", slabs.nbytes)
        global_stats.count("stack_incremental_updates_total")
        global_stats.count("stack_incremental_shards_total", len(dirty))
        return old_arr

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
        """Hit / latch / build / evict. build(stale) receives the stale entry
        for this key (or None) and returns (tensor_or_None, rows_p,
        versions); None means 'cannot be resident' and is not cached."""
        while True:
            with self._lock:
                cached = self._entries.get(key)
                if cached is not None and cached[0] == fingerprint:
                    self._entries[key] = self._entries.pop(key)  # LRU touch
                    return cached[1], cached[2]
                latch = self._building.get(key)
                if latch is None:
                    self._building[key] = threading.Event()
                    break
            latch.wait()
        try:
            arr, rows_p, vers = build(cached)
            if arr is None:
                return None, rows_p
            with self._lock:
                self._entries.pop(key, None)
                self._entries[key] = (fingerprint, arr, rows_p, vers)
                self._evict(keep=key)
            return arr, rows_p
        finally:
            with self._lock:
                self._building.pop(key).set()

    def make_room(self, nbytes: int) -> None:
        """LRU-evict cached stacks until `nbytes` fits under the budget."""
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
        self.evictions += 1

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e[1].numel() * 4 for e in self._entries.values())


class _PairEntry:
    """One field pair's cached sufficient statistics: the in-flight flat
    table right after a sweep (per-shard int32[S, D] or summed int32[D]),
    replaced by the int64 host totals on first resolve. gen_*: the views'
    generations the sweep was keyed on."""

    __slots__ = ("shards", "rf", "rg", "stats", "gen_f", "gen_g")

    def __init__(self, shards, rf, rg, stats, gen_f, gen_g):
        self.shards = shards
        self.rf = rf
        self.rg = rg
        self.stats = stats
        self.gen_f = gen_f
        self.gen_g = gen_g


class _GroupNEntry:
    """One N>=3 field tuple's cached group tensor: totals int64[K, rf, rg]
    served to queries, the per-shard int32[S, K*rf*rg] table they were
    summed from, and the row counts (padded stack heights) fixing the
    tensor geometry. cfp: the (shards, view generations) it was swept at."""

    __slots__ = ("cfp", "stats", "pershard", "rs")

    def __init__(self, cfp, stats, pershard, rs):
        self.cfp = cfp
        self.stats = stats
        self.pershard = pershard
        self.rs = rs


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _eval_spec(spec, blocks_it, scalars_it) -> torch.Tensor:
    """Evaluate a spec tree over [S, W] int32 slabs. Both iterators are
    consumed in the exact order _build emitted them."""
    tag = spec[0]
    if tag == "R":
        block = next(blocks_it)  # [S, R, W]
        row = next(scalars_it)
        mask = next(scalars_it)
        if not mask:  # row beyond the packed range: an empty row
            return torch.zeros_like(block[:, 0, :])
        idx = torch.tensor([row], dtype=torch.int64, device=block.device)
        return torch.index_select(block, 1, idx).squeeze(1)
    if tag == "A":
        return next(blocks_it)[:, 0, :]  # existence stack
    if tag == "N":
        block = next(blocks_it)  # existence stack
        inner = _eval_spec(spec[1], blocks_it, scalars_it)
        return block[:, 0, :] & ~inner
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


class CUDABackend:
    """Device backend for the Executor: Count and Row calls on the card.

    ``device`` defaults to "cuda" and must name a present device; the CPU
    tests pass device="cpu", where every kernel wrapper takes its plain
    PyTorch version. Calls not lowered here go to the CPU oracle."""

    _PAIR_VERBS = {"Intersect": "I", "Union": "U", "Difference": "D", "Xor": "X"}

    #: Per-shard table retention gate: beyond this the pair sweep returns
    #: device-summed totals instead of the per-shard table.
    MAX_PAIR_PERSHARD_BYTES = 32 << 20

    def __init__(self, holder, device="cuda", max_bytes: Optional[int] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDABackend: no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        self.holder = holder
        self.device = device
        self.cpu = CPUBackend(holder)
        self.stats = global_stats
        self.blocks = _StackedBlocks(device, max_bytes)
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
        # GroupBy tensors, under _pair_lock: (cfp, payload) by (index,
        # fields, filter), and the N>=3 per-shard tables (_GroupNEntry).
        self._agg_cache: dict = {}
        self._groupn_cache: dict = {}

    # -- routing and counters ----------------------------------------------

    def _cpu_routed(self, c: Call) -> None:
        """Count a call answered by the CPU oracle (call: the PQL call name,
        a bounded label)."""
        self.stats.with_tags(f"call:{c.name}").count("cpu_routed_total")

    def _launched(self, kind: str) -> None:
        self.stats.with_tags(f"kind:{kind}").count("device_launches_total")
        current_profile().incr("device_launches")

    # -- spec + leaf assembly ----------------------------------------------

    def _get_block(self, index, field_obj, shards, view_name=VIEW_STANDARD, min_rows=1):
        block, rows_p = self.blocks.get(index, field_obj, shards, view_name, min_rows)
        if block is None:
            raise _Unsupported("stack exceeds the device budget")
        return block, rows_p

    def _field(self, index: str, name: str):
        idx = self.holder.index(index)
        f = idx.field(name) if idx else None
        if f is None:
            raise NotFoundError(f"field not found: {name}")
        return f

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
        if any(isinstance(v, Condition) for v in c.args.values()):
            raise _Unsupported("BSI condition")
        field_name = c.field_arg()
        f = self._field(index, field_name)
        row_id, ok = c.uint64_arg(field_name)
        if not ok:
            raise QueryError("Row() must specify row")
        if "from" in c.args or "to" in c.args:
            raise _Unsupported("time range")
        block, rows_p = self._get_block(index, f, shards)
        blocks.append(block)
        scalars.append(min(row_id, rows_p - 1))
        scalars.append(1 if row_id < rows_p else 0)
        return ("R", field_name)

    def _assemble(self, index: str, c: Call, shards: tuple[int, ...]):
        blocks: list = []
        scalars: list = []
        spec = self._build(index, c, shards, blocks, scalars)
        return spec, tuple(blocks), tuple(scalars)

    # -- programs ------------------------------------------------------------

    def _count_program(self, spec, blocks, scalars) -> torch.Tensor:
        """Popcount of the evaluated slab: per-shard counts int32[S] (K3),
        summed on the device in int64, exact for any shard count."""
        slab = _eval_spec(spec, iter(blocks), iter(scalars)).contiguous()
        self._launched("count")
        return popcount_rows(slab).sum(dtype=torch.int64)

    def _vec_program(self, spec, blocks, scalars) -> torch.Tensor:
        """The evaluated bitmap slab int32[S, W]."""
        self._launched("vec")
        return _eval_spec(spec, iter(blocks), iter(scalars))

    # -- backend interface -------------------------------------------------

    def _resident_shards(self, index: str, shard: int) -> tuple[tuple[int, ...], int]:
        """Shard tuple to assemble a single-shard call against: the index's
        full available set, so shard-by-shard calls reuse ONE resident
        stack instead of replacing it with per-shard packs."""
        idx = self.holder.index(index)
        shards = idx.available_shards().to_array().tolist() if idx else []
        if shard in shards:
            return tuple(shards), shards.index(shard)
        return (shard,), 0

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

    @staticmethod
    def _to_host_words(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().view(np.uint32)

    def bitmap_call_shard(self, index: str, c: Call, shard: int) -> Row:
        shards_t, pos = self._resident_shards(index, shard)
        try:
            spec, blocks, scalars = self._assemble(index, c, shards_t)
        except _Unsupported:
            self._cpu_routed(c)
            return self.cpu.bitmap_call_shard(index, c, shard)
        slab = self._vec_program(spec, blocks, scalars)
        cols = unpack_row(self._to_host_words(slab[pos])) + np.uint64(
            shard
        ) * np.uint64(SHARD_WIDTH)
        return Row.from_columns(cols)

    def bitmap_call(self, index: str, c: Call, shards: list[int]) -> Row:
        """Whole-query bitmap: evaluate the stack once, read back the
        requested shards' [S, W] words, unpack on the host."""
        idx = self.holder.index(index)
        avail = idx.available_shards().to_array().tolist() if idx else []
        pos_of = {s: i for i, s in enumerate(avail)}
        if avail and all(s in pos_of for s in shards):
            shards_t = tuple(avail)
            positions = [pos_of[s] for s in shards]
        else:
            shards_t = tuple(shards)
            positions = list(range(len(shards)))
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
        with prof.phase("device_dispatch"):
            slab = self._vec_program(spec, blocks, scalars)
            if positions != list(range(slab.shape[0])):
                idx_t = torch.tensor(positions, dtype=torch.int64, device=slab.device)
                slab = torch.index_select(slab, 0, idx_t)
            host = self._to_host_words(slab)
        with prof.phase("host_reduce"):
            return self._slab_row(host, shards)

    def count_shard(self, index: str, c: Call, shard: int) -> int:
        return self.count_shards(index, c, [shard])

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
        with prof.phase("device_dispatch"):
            return int(self._count_program(spec, blocks, scalars))

    def count_batch(self, index: str, calls: list[Call], shards: list[int]) -> list[int]:
        """Q count queries; see count_batch_async."""
        return self.count_batch_async(index, calls, shards)()

    def count_batch_async(
        self, index: str, calls: list[Call], shards: list[int]
    ) -> Callable[[], list[int]]:
        """Dispatch a batch of count queries and return a resolver.

        When every call is a one- or two-row combination over one field
        pair, ONE pair-stats sweep serves the whole batch. Any other batch
        runs count_shards once per call."""
        if not calls:
            return lambda: []
        shards_t = tuple(shards)
        plan = self._cached_pair_plan(index, calls)
        if plan is not None:
            try:
                return self._pair_batch_dispatch(index, plan, shards_t)
            except _Unsupported:
                pass  # a size gate refused the sweep; per-call counts serve it
        counts = [self.count_shards(index, c, list(shards_t)) for c in calls]
        return lambda: counts

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

    def _pair_program(self, fblock: torch.Tensor, gblock: torch.Tensor,
                      pershard: bool) -> torch.Tensor:
        """One pair sweep: the per-shard table int32[S, D] (K1), or its sum
        over shards int32[D] (K2) past the retention gate."""
        self._launched("pair_stats")
        if pershard:
            return pair_stats_pershard(fblock, gblock)
        return pair_stats(fblock, gblock)

    def _pair_batch_dispatch(self, index, plan, shards_t):
        entries, fa, fb = plan
        return functools.partial(self._pair_fetch, entries,
                                 self._pair_entry(index, fa, fb, shards_t))

    def _pair_entry(self, index, fa, fb, shards_t) -> _PairEntry:
        """The fresh pair entry of (fa, fb) over shards_t: a cache hit, or
        one sweep. Raises _Unsupported when a gate refuses the sweep."""
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
                index, fa, fb, f_obj, g_obj, shards_t, ckey, gen_f, gen_g
            )
        finally:
            with self._pair_lock:
                ev = self._stats_updating.pop(ckey, None)
            if ev is not None:
                ev.set()

    def _pair_refresh(self, index, fa, fb, f_obj, g_obj,
                      shards_t, ckey, gen_f, gen_g) -> _PairEntry:
        """The single-flight body: fetch (build or splice) the stacks, then
        one sweep. The generations were read before the stacks, so an entry
        is never fresher than its key says (a write racing the build costs
        one more sweep, never a stale answer)."""
        prof = current_profile()
        with prof.phase("stack_fetch"):
            fblock, _ = self._get_block(index, f_obj, shards_t)
            gblock = fblock if fb == fa else self._get_block(index, g_obj, shards_t)[0]
        rf, rg = fblock.shape[1], gblock.shape[1]
        reason, pershard_ok = self._pair_gates(fblock.shape[0], rf, rg)
        if reason is not None:
            raise _Unsupported(reason)
        self.stats.count("pair_stats_sweeps_total")
        with prof.phase("device_dispatch"):
            flat = self._pair_program(fblock, gblock, pershard_ok)
        ent = _PairEntry(shards_t, rf, rg, flat, gen_f, gen_g)
        with self._pair_lock:
            self._pair_cache.pop(ckey, None)
            self._pair_cache[ckey] = ent
            while len(self._pair_cache) > MAX_PAIR_CACHE_ENTRIES:
                self._pair_cache.pop(next(iter(self._pair_cache)))
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

    def _pair_fetch(self, entries, ent) -> list[int]:
        """Derive the batch's counts from the entry's stats."""
        with current_profile().phase("host_reduce"):
            return self._pair_resolve(entries, self._pair_totals(ent), ent.rf, ent.rg)

    def _pair_totals(self, ent) -> np.ndarray:
        """The entry's int64 host totals [D]: the device table is read back
        on first touch and replaced by its totals."""
        stats = ent.stats
        if isinstance(stats, np.ndarray):
            return stats
        raw = stats.cpu().numpy()  # ONE readback for all stats
        totals = (raw.sum(axis=0, dtype=np.int64) if raw.ndim == 2
                  else raw.astype(np.int64))
        with self._pair_lock:
            if ent.stats is stats:  # idempotent: racers read back too
                ent.stats = totals
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
        # Unfiltered 2-field groups ARE the pair-count matrix, which the
        # pair batch path sweeps and caches. (The JAX package also serves
        # unfiltered 1-field groups from its TopN rank tables; the port has
        # no TopN tables yet, so they take the tensor path below, which
        # gives the same counts.)
        if filter_call is None and n == 2:
            pm = self._pair_matrix(index, fields[0][0], fields[1][0], shards_t)
            if pm is not None:
                matrix, rf, rg = pm
                return self._group_enumerate(
                    fields, starts, child_rows, [rf, rg], matrix, n, cap
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
                spec, blocks, scalars = self._assemble(index, filter_call, shards_t)
                filt = self._vec_program(spec, blocks, scalars).contiguous()
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
            with current_profile().phase("device_dispatch"):
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
        """Gauge of the host bytes the cached group tensors pin; called
        under _pair_lock after every store, so it tracks the LRU exactly."""
        total = 0
        for _, payload in self._agg_cache.values():
            total += sum(p.nbytes for p in payload if isinstance(p, np.ndarray))
        self.stats.gauge("agg_cache_bytes", total)

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
        on the card) or the int64[Rf, Rg] pair matrix (K2)."""
        f = stacks[0]
        if filt is not None:
            f = f & filt[:, None, :]
        self._launched("groupby")
        if len(stacks) == 1:
            s, r, w = f.shape
            counts = popcount_rows(f.reshape(s * r, w)).reshape(s, r)
            return counts.sum(dim=0, dtype=torch.int64).cpu().numpy()
        rf, rg = f.shape[1], stacks[1].shape[1]
        flat = pair_stats(f, stacks[1])
        return flat[: rf * rg].reshape(rf, rg).cpu().numpy().astype(np.int64)

    def _group_live_rows(self, stacks) -> list:
        """Per extra field, its live row ids: the rows with any bit in the
        swept stacks (K3 per-row popcounts). Sound by construction: the
        counts come from the tensors every tile sweeps, so a pruned row is
        zero in every cell it would have produced."""
        out = []
        for st in stacks[2:]:
            s, r, w = st.shape
            self._launched("groupby")
            counts = popcount_rows(st.reshape(s * r, w)).reshape(s, r)
            live = counts.sum(dim=0, dtype=torch.int64).cpu().numpy() > 0
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
            shape = (0, int(f.shape[0]), rf, rg) if pershard else (0, rf, rg)
            return np.zeros(shape, np.int32)
        kind = "group_tile_pershard" if pershard else "group_tile"
        pending = []
        for c0 in range(0, len(combos), MAX_GROUP_TILE_SLOTS):
            rows_idx = combos[c0 : c0 + MAX_GROUP_TILE_SLOTS]
            active = np.ones(len(rows_idx), np.int32)
            self.stats.count("groupby_tiles_total")
            self.stats.histogram("groupby_tile_occupancy", len(rows_idx))
            self._launched(kind)
            if pershard:
                pending.append(group_tile_stats_pershard(f, g, extras, rows_idx, active))
            else:
                pending.append(group_tile_stats(f, g, extras, rows_idx, active, filt))
        return np.concatenate([t.cpu().numpy() for t in pending])

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
            shapes.append((len(shards_t), _padded_rows(n_rows), WORDS_PER_SHARD))
        return tuple(shapes)

    def _groupn_tensor(self, index, fields, shards_t):
        """(totals int64[K, rf, rg], rs) for an unfiltered N>=3 GroupBy from
        the retained per-shard table, or None when this path cannot serve
        (repeated field, size gates) and the generic tiled path should. A
        write epoch re-dispatches the sweep (the JAX package's host-side
        incremental tier is not ported yet)."""
        fobjs = [fo for _, fo in fields]
        if len({id(f) for f in fobjs}) != len(fobjs):
            return None  # repeated field
        ckey = ("groupn", index, tuple(fn for fn, _ in fields))
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
            return self._groupn_dispatch(index, fobjs, shards_t, ckey, cfp)
        finally:
            with self._pair_lock:
                ev = self._stats_updating.pop(ckey, None)
            if ev is not None:
                ev.set()

    def _groupn_dispatch(self, index, fobjs, shards_t, ckey, cfp):
        prof = current_profile()
        try:
            with prof.phase("stack_fetch"):
                stacks = [self._get_block(index, f, shards_t)[0] for f in fobjs]
        except _Unsupported:
            return None  # over the device budget: the generic path decides
        rs = [int(st.shape[1]) for st in stacks]
        k_total = _prod(rs[2:])
        face = rs[0] * rs[1]
        s = int(stacks[0].shape[0])
        if s > MAX_PAIR_SHARDS or face > (1 << 16):
            return None
        if s * k_total * face * 4 > self.MAX_PAIR_PERSHARD_BYTES:
            return None  # table too big to retain: the generic path sweeps
        with prof.phase("device_dispatch"):
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
        ent = _GroupNEntry(cfp, totals, pershard, rs)
        with self._pair_lock:
            self._groupn_cache.pop(ckey, None)
            self._groupn_cache[ckey] = ent
            while len(self._groupn_cache) > MAX_PAIR_CACHE_ENTRIES:
                self._groupn_cache.pop(next(iter(self._groupn_cache)))
        return totals, rs

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
