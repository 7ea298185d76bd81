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

Calls without a device lowering here (BSI conditions, time ranges, Shift)
raise _Unsupported while their tree is assembled and are answered by the
CPU oracle, counted in ``cpu_routed_total{call}``. Kernel failures are not
caught: they raise to the caller.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional

import numpy as np
import torch

from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import VIEW_STANDARD
from pilosa_tpu_torch.exec.cpu import CPUBackend, NotFoundError, QueryError
from pilosa_tpu_torch.ops.blocks import (
    WORDS_PER_SHARD,
    _padded_rows,
    pack_fragment,
    unpack_row,
    unpack_slab_columns,
)
from pilosa_tpu_torch.ops.kernels import (
    MAX_PAIR_SHARDS,
    pair_stats,
    pair_stats_pershard,
    popcount_rows,
)
from pilosa_tpu_torch.pql.ast import Call, Condition
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.utils.locks import InstrumentedRLock
from pilosa_tpu_torch.utils.qprofile import current_profile
from pilosa_tpu_torch.utils.stats import global_stats

_DEVICE_LOWERED = ("Row", "Range", "Union", "Intersect", "Difference", "Xor", "Not", "All")

# Pair-stats host cache bound: entries may hold in-flight device tables, so
# the LRU cap keeps many-field indexes from pinning device memory.
MAX_PAIR_CACHE_ENTRIES = 16


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
        f_obj = self._field(index, fa)
        g_obj = self._field(index, fb)
        ckey = (index, fa, fb)
        # Hit gate + single-flight admission: generations are read inside
        # the loop so a waiter re-checks against the freshest epoch.
        with current_profile().phase("freshness"):
            while True:
                fv = f_obj.view(VIEW_STANDARD)
                gv = g_obj.view(VIEW_STANDARD)
                gen_f = fv.generation if fv is not None else -1
                gen_g = gv.generation if gv is not None else -1
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
                        return functools.partial(self._pair_fetch, entries, hit)
                    latch = self._stats_updating.get(ckey)
                    if latch is None:
                        self._stats_updating[ckey] = threading.Event()
                        break
                latch.wait(timeout=60)
        try:
            return self._pair_refresh(
                index, entries, fa, fb, f_obj, g_obj, shards_t, ckey, gen_f, gen_g
            )
        finally:
            with self._pair_lock:
                ev = self._stats_updating.pop(ckey, None)
            if ev is not None:
                ev.set()

    def _pair_refresh(self, index, entries, fa, fb, f_obj, g_obj,
                      shards_t, ckey, gen_f, gen_g):
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
        return functools.partial(self._pair_fetch, entries, ent)

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
        """Resolve the stats (device table on first touch, host totals
        after) and derive the batch's counts."""
        with current_profile().phase("host_reduce"):
            stats = ent.stats
            if not isinstance(stats, np.ndarray):
                raw = stats.cpu().numpy()  # ONE readback for all stats
                totals = (raw.sum(axis=0, dtype=np.int64) if raw.ndim == 2
                          else raw.astype(np.int64))
                with self._pair_lock:
                    if ent.stats is stats:  # idempotent: racers read back too
                        ent.stats = totals
            else:
                totals = stats
            return self._pair_resolve(entries, totals, ent.rf, ent.rg)

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
