"""Epoch-tagged result cache: serve hot PQL answers at memory speed
(the JAX package's exec/rescache.py, its imports rewritten).

Terminal query answers (Count, bitmap Row results, TopN, Sum/Min/Max,
GroupBy) are cached keyed on (index, canonicalized PQL spelling,
resolved shard set, option flags) and TAGGED with an epoch vector
derived from the views' mutation journals:

- per covered FIELD: the field object identity + its structure_version
  (bumps on view/fragment create/delete and available-shard changes —
  the "shape" axis a data-generation can't see, e.g. the first write
  into a previously empty field);
- per covered VIEW: the view object identity + its data generation
  (core/view.py `generation`, minted from the process-global atomic
  counter on every fragment mutation).

Entries are never *invalidated* by writes — a lookup revalidates the
recorded vector against the live views, and the journal
(`View.dirty_shards_since`) refines a generation mismatch down to the
set of shards that actually moved: a write OUTSIDE the query's covered
shard set keeps the entry addressable, a write inside it (or a
structural change, or a journal-evicted window) makes the entry
unaddressable until a fresh answer replaces it. Object-identity checks
make deleted-and-recreated fields/views unaddressable even though names
collide (generations come from one global counter, so values never
repeat, but an empty recreated view has an empty journal that would
otherwise "explain" the window).

`max_staleness` (default 0 = exact-epoch only) is the documented
bounded-staleness contract: a generation-mismatched entry whose every
covered view is at most N generations behind may still be served.
Generations count the PROCESS-GLOBAL write counter, so N bounds the
total number of mutations (across all views) that could have touched
the answer since it was computed — a conservative, monotone knob:
raising it only ever raises hit rate. Structural mismatches are never
served stale: no bound is derivable for them.

Memory is governed by a strict ledger under an LRU bound: every entry
carries an accounted byte size, the `rescache_resident_bytes` and
`rescache_entries` gauges equal the sum over live entries at all times,
and inserts evict coldest-first until the budget holds. /debug/rescache dumps the ledger coldest-first.

Scope: the cache consults at a single-node COORDINATOR and on remote
per-node legs (opt.remote), where every covered view is local and the
local journal explains every write. A CLUSTERED coordinator consults
too, once the cluster layer installs `peer_epochs_provider`: fan-out entries carry the merged (local +
peer) epoch vector — the peer part is each covering node's
last-piggybacked view epochs (X-Pilosa-View-Epochs on internal RPC
responses, folded by cluster/cluster.py) — and revalidation compares
it against the live map, so a peer write the coordinator has heard
about makes the entry unservable. Writes routed THROUGH the
coordinator (replica writes, imports) piggyback synchronously; writes
entering via other nodes are bounded by the failure detector's
~1 s /status probes (the documented freshness window,
docs/administration.md "Result caching").

Concurrency: one leaf lock guards the map + ledger; epoch resolution
and revalidation (which take view journal locks) happen OUTSIDE it.
Concurrent misses on one key each execute and the last commit wins —
the thundering-herd window is one epoch wide and self-heals. Cached
values are SHARED between requests and must never be mutated.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from pilosa_tpu_torch.pql.ast import Call, canonical_key
from pilosa_tpu_torch.utils.locks import InstrumentedLock
from pilosa_tpu_torch.utils.stats import global_stats

#: Calls whose final answers the cache may hold. Everything else —
#: writes, Options, schema-ish calls, pagination helpers — executes
#: normally. Rows/Range stay out: their time-quantum paths default an
#: open `to` bound to "now", which is not a function of the epoch.
CACHEABLE_CALLS = frozenset((
    "Count", "Row", "Intersect", "Union", "Xor", "Difference", "Not",
    "All", "Shift", "TopN", "Sum", "Min", "Max", "GroupBy",
))

#: Inner calls the coverage walk understands (CACHEABLE_CALLS plus the
#: read-only children that appear under them). An unknown name anywhere
#: in the tree makes the whole query uncacheable — never guess coverage.
_WALKABLE_CALLS = CACHEABLE_CALLS | {"Rows"}

#: Arg keys whose presence makes a call time-dependent (open time
#: bounds resolve against the wall clock) — uncacheable by contract.
_TIME_ARGS = ("from", "to", "_start", "_end", "_timestamp")

#: Calls that read the index's existence field implicitly.
_EXISTENCE_CALLS = ("Not", "All")


class _Token:
    """One begin()'d lookup: either a hit carrying the value, or a miss
    carrying the key + pre-execution epoch vector for commit(). After a
    hit or a retained commit, `entry` links to the cache entry so the
    serialization layer can read/attach pre-encoded wire bytes."""

    __slots__ = ("key", "index", "fields_sig", "views_sig", "peers_sig",
                 "hit", "value", "stale_by", "entry", "_shard_set",
                 "_shards_t", "_pql")

    def __init__(self, key, index, fields_sig, views_sig, peers_sig=None):
        self.key = key
        self.index = index
        self.fields_sig = fields_sig
        self.views_sig = views_sig
        # Peer epoch vector: the covering peers'
        # last-piggybacked view epochs at begin() time, None on a
        # single node, () when the shard set is covered locally.
        self.peers_sig = peers_sig
        self.hit = False
        self.value = None
        self.stale_by = 0
        self.entry = None


#: Wire-bytes memo bound per entry: one fragment per encoding-flags
#: combination (today: JSON with/without columns). A response shape the
#: entry has not served yet just encodes once more.
_MAX_WIRE_VARIANTS = 4


class _Entry:
    __slots__ = ("key", "index", "pql", "shard_set", "shards_t", "value",
                 "nbytes", "fields_sig", "views_sig", "peers_sig", "hits",
                 "inserted_mono", "wire")

    def __init__(self, key, index, pql, shard_set, shards_t, value, nbytes,
                 fields_sig, views_sig, peers_sig=None):
        self.key = key
        self.index = index
        self.pql = pql
        self.shard_set = shard_set
        self.shards_t = shards_t  # interned tuple (provider memo key)
        self.value = value
        self.nbytes = nbytes
        self.fields_sig = fields_sig
        self.views_sig = views_sig
        self.peers_sig = peers_sig
        self.hits = 0
        self.inserted_mono = time.monotonic()
        # Pre-encoded response fragments keyed by encoding flags:
        # a hit serves these bytes straight
        # into the response envelope, skipping `serialize` entirely.
        # Attached lazily by the serialization layer (attach_wire);
        # accounted bytes charge the encoded payload.
        self.wire: dict = {}


def result_nbytes(value: Any) -> int:
    """Accounted size of a cached answer, in bytes. An estimate of the
    retained-object footprint — what matters is that it is STRICT and
    internally consistent: the resident gauge is always exactly the sum
    of these over live entries (asserted in tests, like the device
    ledger's tier sums)."""
    from pilosa_tpu_torch.core.cache import Pair
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.exec.result import (
        GroupCount,
        PairField,
        PairsField,
        RowIDs,
        ValCount,
    )

    if value is None:
        return 16
    if isinstance(value, bool) or isinstance(value, (int, float)):
        return 32
    if isinstance(value, str):
        return 56 + len(value)
    if isinstance(value, Row):
        # Size from the LAZY representation: count() reads the columns
        # array length (or sums container cardinalities) without
        # forcing a lazy Row to materialize the full uint64 column
        # array just to read .nbytes (insert-time
        # accounting used to materialize every cached Row).
        n = 112 + 8 * value.count()
        if value.keys:
            n += sum(56 + len(k) for k in value.keys)
        if value.attrs:
            n += sum(56 + len(str(k)) + 32 for k in value.attrs)
        return n
    if isinstance(value, ValCount):
        return 96
    if isinstance(value, Pair):
        return 64 + (len(value.key) if value.key else 0)
    if isinstance(value, PairsField):
        return 80 + sum(result_nbytes(p) for p in value.pairs)
    if isinstance(value, PairField):
        return 80 + result_nbytes(value.pair)
    if isinstance(value, RowIDs):
        n = 64 + 32 * len(value)
        if value.keys is not None:
            n += sum(56 + len(k) for k in value.keys)
        return n
    if isinstance(value, GroupCount):
        return 64 + sum(
            64 + len(fr.field) + len(fr.row_key) for fr in value.group
        )
    if isinstance(value, (list, tuple)):
        return 56 + 8 * len(value) + sum(result_nbytes(v) for v in value)
    import sys

    return 64 + int(sys.getsizeof(value))


class ResultCache:
    #: Exposed for callers that need to know whether a bypass skipped a
    #: lookup that would otherwise have happened (executor bypass count).
    CACHEABLE = CACHEABLE_CALLS

    def __init__(self, holder, max_bytes: int, max_staleness: int = 0):
        if max_bytes <= 0:
            raise ValueError(
                "ResultCache needs a positive byte budget; "
                "0 means disabled — don't construct one"
            )
        self.holder = holder
        self.max_bytes = int(max_bytes)
        self.max_staleness = int(max_staleness)
        # Peer-epoch provider, installed by
        # Cluster.attach: (index, field_names, shards_tuple) -> a tuple
        # signature of every covering peer's last-piggybacked view
        # epochs, () when the shard set is locally covered, or None when
        # some covering peer's state is unknown (uncacheable). When set,
        # a CLUSTERED coordinator may consult this cache: its entries
        # carry the merged (local + peer) epoch vector, and revalidation
        # compares the peer part against the live map — a peer write
        # piggybacked since then makes the entry unservable.
        self.peer_epochs_provider = None
        # Leaf lock: guards _entries/_resident/_salt and NOTHING else is
        # acquired while holding it except the stats registry lock
        # (gauge writes stay inside so two interleaved commits can't
        # publish out of order — the begin_query precedent). Epoch
        # resolution/revalidation take view journal locks OUTSIDE it.
        self._lock = InstrumentedLock("rescache")
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._resident = 0
        # Per-index addressability salt: bumped by invalidate_index()
        # (attr-plane writes, which no view generation witnesses). Old
        # entries stop being addressable and age out via LRU.
        self._salt: dict[str, int] = {}
        # Lifetime totals for /debug/rescache (the per-index counters
        # also land in global_stats).
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.bypass = 0
        self.stale_hits = 0
        # canonical_key memo for parse-cache-pinned trees (Call.cached
        # — identity-stable by the parse cache's contract, the same
        # soundness argument as the pair-plan cache's id keying). The
        # memo holds a strong ref to each call, so an id can never be
        # reused while its entry lives; bounded by wholesale clear.
        self._key_memo: dict[int, tuple] = {}
        # Shard tuple/frozenset intern table: at the flagship shape a
        # query's shard set is ~1k ints, and every entry for an index
        # shares the SAME set — interning makes keys share one tuple
        # object and entries one frozenset instead of duplicating ~38KB
        # per entry. Bounded by wholesale clear.
        self._shards_intern: dict[tuple, tuple] = {}

    def _intern_shards(self, shards) -> tuple:
        """(tuple, frozenset) for a shard list, interned so every key
        and entry over the same shard set shares two objects total."""
        t = tuple(shards)
        got = self._shards_intern.get(t)
        if got is not None:
            return got
        if len(self._shards_intern) > 64:
            self._shards_intern.clear()
        pair = (t, frozenset(t))
        self._shards_intern[t] = pair
        return pair

    def _canonical(self, call: Call) -> str:
        """canonical_key with an identity memo for pinned parse-cache
        trees — the hot Zipf head re-presents the SAME Call objects, so
        the canonicalize walk + stringify runs once per distinct query,
        not once per request."""
        if not call.cached:
            return canonical_key(call)
        hit = self._key_memo.get(id(call))
        if hit is not None:
            return hit[1]
        key = canonical_key(call)
        if len(self._key_memo) > 4096:
            self._key_memo.clear()
        self._key_memo[id(call)] = (call, key)
        return key

    # -- coverage resolution ------------------------------------------------

    def _collect(self, c: Call, fields: set, flags: dict) -> bool:
        """Walk a call tree collecting referenced field names; False =
        uncacheable (unknown call, time-dependent args)."""
        if c.name not in _WALKABLE_CALLS:
            return False
        for k in _TIME_ARGS:
            if k in c.args:
                return False
        if c.name == "Row":
            # First non-reserved arg = the field (ast.field_arg); any
            # from/to time bound was already rejected above.
            for arg in c.args:
                if not arg.startswith("_"):
                    fields.add(arg)
                    break
        elif c.name in ("Rows", "TopN"):
            fn = c.args.get("_field") or c.args.get("field")
            if not fn:
                return False
            fields.add(fn)
        elif c.name in ("Sum", "Min", "Max"):
            fn = c.args.get("field")
            if not fn:
                for arg in c.args:
                    if not arg.startswith("_"):
                        fn = arg
                        break
            if not fn:
                return False
            fields.add(fn)
        if c.name in _EXISTENCE_CALLS:
            flags["existence"] = True
        for k, v in c.args.items():
            if isinstance(v, Call) and not self._collect(v, fields, flags):
                return False
        for child in c.children:
            if not self._collect(child, fields, flags):
                return False
        return True

    def _epoch_vector(self, index: str, c: Call):
        """((field sig...), (view sig...)) for the fields `c` reads, or
        None when coverage cannot be established (uncacheable). Field
        sig = (name, field object, structure_version); view sig =
        (field, view name, view object, generation). Object identities
        pin against delete-and-recreate; versions/generations carry the
        epoch."""
        idx = self.holder.index(index)
        if idx is None:
            return None
        names: set = set()
        flags: dict = {}
        if not self._collect(c, names, flags):
            return None
        fobjs = []
        for name in sorted(names):
            f = idx.field(name)
            if f is None:
                return None  # the query will error; nothing to cache
            fobjs.append(f)
        if flags.get("existence"):
            ef = idx.existence_field()
            if ef is None:
                return None
            fobjs.append(ef)
        fields_sig = []
        views_sig = []
        for f in fobjs:
            fields_sig.append((f.name, f, f.structure_version))
            # list(dict.items()) is atomic under the GIL; a concurrent
            # view create lands as a structure_version mismatch at
            # revalidation, not a torn walk.
            for vname, v in sorted(list(f.views.items())):
                views_sig.append((f.name, vname, v, v.generation))
        return tuple(fields_sig), tuple(views_sig)

    def _peer_vector(self, index: str, fields_sig, shards_t, remote: bool):
        """(ok, peers_sig): the covering peers' epoch signature for this
        key, or (False, None) = uncacheable. None provider (single node)
        and remote legs (local coverage by construction) carry no peer
        vector."""
        if self.peer_epochs_provider is None or remote:
            return True, None
        sig = self.peer_epochs_provider(
            index, [fs[0] for fs in fields_sig], shards_t
        )
        if sig is None:
            return False, None
        return True, sig

    def _revalidate(self, entry: _Entry) -> tuple[bool, int]:
        """(addressable, generations_behind) for a stored entry against
        the LIVE schema: identity + structure must match exactly; a data
        generation mismatch survives when the journal proves every write
        landed outside the entry's shard set, else it counts how far
        behind the entry is (for the max_staleness contract). -1 behind
        = unbounded (structural / journal-evicted), never served."""
        idx = self.holder.index(entry.index)
        if idx is None:
            return False, -1
        for fname, fobj, sver in entry.fields_sig:
            f = idx.field(fname)
            if f is not fobj or f.structure_version != sver:
                return False, -1
        behind = 0
        for fname, vname, vobj, gen in entry.views_sig:
            f = idx.field(fname)
            v = f.view(vname) if f is not None else None
            if v is not vobj:
                return False, -1
            cur = v.generation
            if cur == gen:
                continue
            dirty = v.dirty_shards_since(gen)
            if dirty is None:
                return False, -1
            if entry.shard_set.isdisjoint(dirty):
                continue  # writes landed outside the covered shards
            behind = max(behind, cur - gen)
        if entry.peers_sig is not None:
            # Clustered-coordinator entry: the peer part of the vector
            # must match the CURRENT per-peer epoch map exactly — a
            # peer write piggybacked since this entry was recorded (or
            # ownership moving to a peer we haven't heard from) makes
            # it unservable. Never stale-servable: no generation-count
            # bound is derivable across nodes.
            provider = self.peer_epochs_provider
            if provider is None:
                return False, -1
            cur_sig = provider(
                entry.index, [fs[0] for fs in entry.fields_sig],
                entry.shards_t,
            )
            if cur_sig != entry.peers_sig:
                return False, -1
        return True, behind

    # -- the serving API ----------------------------------------------------

    def begin(
        self,
        index: str,
        call: Call,
        shards,
        exclude_row_attrs: bool = False,
        remote: bool = False,
    ) -> Optional[_Token]:
        """Consult the cache for one terminal call. None = uncacheable
        (execute normally, nothing to commit). A returned token is
        either a hit (token.hit, token.value) or a miss the caller MUST
        commit() with the computed answer (exceptions excepted: an
        uncommitted miss token is simply dropped)."""
        if call.name not in CACHEABLE_CALLS:
            return None
        shards_t, shard_set = self._intern_shards(shards)
        # Option flags fold into the key only where they change the
        # answer: exclude_row_attrs alters Row attr attachment (Range
        # is not cacheable — open time bounds resolve against the wall
        # clock); remote legs return per-node partials (untrimmed TopN,
        # capped GroupBy) that must never collide with coordinator
        # answers.
        flag_bits = (
            exclude_row_attrs and call.name == "Row",
            remote,
        )
        pql = self._canonical(call)
        salt = self._salt.get(index, 0)
        key = (index, pql, shards_t, flag_bits, salt)
        with self._lock:
            entry = self._entries.get(key)
        if entry is not None:
            # Hit path: revalidate against the ENTRY's recorded vector
            # — no fresh coverage walk needed (identity + structure +
            # journal checks are the whole freshness story).
            ok, behind = self._revalidate(entry)
            if ok and 0 <= behind <= self.max_staleness:
                with self._lock:
                    if key in self._entries:
                        self._entries.move_to_end(key)
                    entry.hits += 1
                    self.hits += 1
                    if behind:
                        self.stale_hits += 1
                token = _Token(key, index, None, None)
                token.hit = True
                token.value = entry.value
                token.stale_by = behind
                token.entry = entry
                global_stats.with_tags(f"index:{index}").count(
                    "rescache_hits_total"
                )
                return token
        # Miss path: NOW pay the coverage walk, pre-execution — the
        # vector must be snapshotted before any data is read so a write
        # racing the execution ages the entry out early, never late.
        # The peer vector snapshots the same way: the coordinator's map
        # may lag the peer's true state, in which case the entry is
        # tagged with the OLDER epochs and the fan-out's own piggyback
        # advances the map past it — the entry ages out one fan-out
        # early, never late.
        sig = self._epoch_vector(index, call)
        if sig is None:
            return None
        ok, peers_sig = self._peer_vector(index, sig[0], shards_t, remote)
        if not ok:
            return None  # a covering peer's epochs are unknown (yet)
        token = _Token(key, index, sig[0], sig[1], peers_sig)
        with self._lock:
            self.misses += 1
        global_stats.with_tags(f"index:{index}").count("rescache_misses_total")
        token._shard_set = shard_set  # noqa: SLF001 — token-internal carry
        token._shards_t = shards_t  # noqa: SLF001
        token._pql = pql  # noqa: SLF001
        return token

    def commit(self, token: _Token, value: Any) -> None:
        """Populate a missed key with its computed answer (tagged with
        the PRE-execution epoch vector — a write racing the execution
        makes the entry unaddressable one epoch early, never late).
        Negative results (0-count, empty rows) cache like any other."""
        if token.hit:
            return
        # Accounted size: the answer plus the key's UNSHARED parts (the
        # canonical PQL string and tuple scaffolding). The shard tuple/
        # frozenset are interned — one object per distinct shard set,
        # not per entry — so charging them per entry would both lie and
        # shrink the effective budget ~38x at the 954-shard shape.
        nbytes = 160 + len(token._pql) + len(token.index) + result_nbytes(
            value
        )
        if nbytes > self.max_bytes:
            # An answer alone larger than the whole budget is never
            # retained — and must not flush the live entries on its way
            # through (the old evict-until-it-fits
            # loop emptied the cache before discovering nothing fit).
            # The insert+evict pair still counts: visible churn.
            with self._lock:
                self.inserts += 1
                self.evictions += 1
            stats = global_stats.with_tags(f"index:{token.index}")
            stats.count("rescache_inserts_total")
            stats.count("rescache_evictions_total")
            return
        entry = _Entry(
            token.key, token.index, token._pql,
            token._shard_set, token._shards_t, value, nbytes,
            token.fields_sig, token.views_sig, token.peers_sig,
        )
        evicted = 0
        with self._lock:
            old = self._entries.pop(token.key, None)
            if old is not None:
                self._resident -= old.nbytes
            self._entries[token.key] = entry
            self._resident += nbytes
            while self._resident > self.max_bytes and len(self._entries) > 1:
                _, cold = self._entries.popitem(last=False)
                self._resident -= cold.nbytes
                evicted += 1
            self.inserts += 1
            self.evictions += evicted
            global_stats.gauge("rescache_resident_bytes", self._resident)
            global_stats.gauge("rescache_entries", len(self._entries))
        token.entry = entry
        stats = global_stats.with_tags(f"index:{token.index}")
        stats.count("rescache_inserts_total")
        if evicted:
            stats.count("rescache_evictions_total", evicted)

    # -- wire-bytes plane ---------------------------------------------------

    def wire_for(self, token: Optional[_Token], flags) -> Optional[bytes]:
        """The pre-encoded response fragment for a hit/committed token
        under one encoding-flags combination, or None (encode fresh,
        then attach_wire). Entry revalidation already happened in
        begin(); the fragment is a pure function of (value, flags), so
        no further freshness check is needed."""
        if token is None or token.entry is None:
            return None
        return token.entry.wire.get(flags)

    def attach_wire(self, token: Optional[_Token], flags, data: bytes) -> None:
        """Memoize one encoded response fragment on the token's entry so
        the NEXT hit writes these bytes instead of re-paying serialize.
        Byte accounting charges the encoded payload: the ledger grows by
        len(data) and the LRU bound still holds (entries carrying wire
        bytes are exactly as evictable as before)."""
        entry = token.entry if token is not None else None
        if entry is None or len(entry.wire) >= _MAX_WIRE_VARIANTS:
            return
        if entry.nbytes + len(data) > self.max_bytes:
            # commit()'s oversized guard, mirrored for the wire payload:
            # an entry whose ENCODED form would
            # exceed the whole budget must neither pin the ledger above
            # max_bytes nor flush every other live entry on its way in.
            # The fragment is simply not memoized — hits re-encode.
            return
        evicted = 0
        with self._lock:
            if flags in entry.wire:
                return
            entry.wire[flags] = data
            # Charge only while the entry is live in the ledger; a
            # just-evicted entry's memo still serves THIS request's
            # token but owes the ledger nothing.
            if self._entries.get(entry.key) is entry:
                entry.nbytes += len(data)
                self._resident += len(data)
                while (
                    self._resident > self.max_bytes
                    and len(self._entries) > 1
                ):
                    k, cold = next(iter(self._entries.items()))
                    if cold is entry:
                        break  # never evict the entry being served
                    self._entries.pop(k)
                    self._resident -= cold.nbytes
                    evicted += 1
                self.evictions += evicted
                global_stats.gauge(
                    "rescache_resident_bytes", self._resident
                )
                global_stats.gauge("rescache_entries", len(self._entries))
        if evicted:
            global_stats.with_tags(f"index:{token.index}").count(
                "rescache_evictions_total", evicted
            )

    def count_bypass(self, index: str, n: int = 1) -> None:
        """An X-Pilosa-Cache: bypass request skipped N lookups."""
        with self._lock:
            self.bypass += n
        global_stats.with_tags(f"index:{index}").count(
            "rescache_bypass_total", n
        )

    def invalidate_index(self, index: str) -> None:
        """Make every entry for `index` unaddressable (salt bump). Used
        for the attr-store plane (SetRowAttrs/SetColumnAttrs), which no
        view generation witnesses. Stale entries age out via LRU."""
        with self._lock:
            self._salt[index] = self._salt.get(index, 0) + 1

    # -- introspection ------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def debug_dump(self, max_entries: int = 256) -> dict:
        """The /debug/rescache payload: ledger totals + entries sorted
        coldest-first (= LRU eviction order)."""
        now = time.monotonic()
        with self._lock:
            entries = [
                {
                    "index": e.index,
                    "query": e.pql[:200],
                    "shards": len(e.shard_set),
                    "bytes": e.nbytes,
                    "hits": e.hits,
                    "ageSeconds": round(now - e.inserted_mono, 3),
                }
                for e in list(self._entries.values())[:max_entries]
            ]
            return {
                "enabled": True,
                "residentBytes": self._resident,
                "maxBytes": self.max_bytes,
                "maxStaleness": self.max_staleness,
                "entries": entries,
                "entryCount": len(self._entries),
                "hits": self.hits,
                "staleHits": self.stale_hits,
                "misses": self.misses,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "bypass": self.bypass,
            }
