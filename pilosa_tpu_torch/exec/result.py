"""Executor result types (reference executor.go / row.go result shapes)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from pilosa_tpu_torch.core.cache import Pair


@dataclass
class ValCount:
    """Sum/Min/Max result (reference ValCount executor.go)."""

    val: int = 0
    count: int = 0

    def to_json(self) -> dict:
        return {"value": self.val, "count": self.count}


@dataclass
class PairsField:
    """TopN result: pairs + the field they came from."""

    pairs: list[Pair] = field(default_factory=list)
    field_name: str = ""

    def to_json(self) -> list:
        out = []
        for p in self.pairs:
            if p.key:
                out.append({"key": p.key, "count": p.count})
            else:
                out.append({"id": p.id, "count": p.count})
        return out


@dataclass
class PairField:
    """MinRow/MaxRow result: a single pair (reference PairField)."""

    pair: Pair = field(default_factory=lambda: Pair(0, 0))
    field_name: str = ""

    def to_json(self) -> dict:
        if self.pair.key:
            return {"key": self.pair.key, "count": self.pair.count}
        return {"id": self.pair.id, "count": self.pair.count}


class RowIDs(list):
    """Rows() result: sorted row IDs with limit-aware merge
    (reference executor.go RowIDs.merge). When the field is keyed the
    executor fills `keys` and the JSON form emits them instead
    (reference RowIdentifiers marshaling)."""

    keys: Optional[list[str]] = None

    def merge(self, other: "RowIDs", limit: int) -> "RowIDs":
        seen = set(self)
        out = sorted(seen | set(other))
        return RowIDs(out[:limit])

    def to_json(self) -> dict:
        if self.keys is not None:
            return {"keys": self.keys}
        return {"rows": list(self)}


@dataclass
class FieldRow:
    """One (field, row) of a GroupBy group (reference executor.go:1154)."""

    field: str
    row_id: int
    row_key: str = ""

    def to_json(self) -> dict:
        if self.row_key:
            return {"field": self.field, "rowKey": self.row_key}
        return {"field": self.field, "rowID": self.row_id}


@dataclass
class GroupCount:
    """One GroupBy result group (reference executor.go:1187)."""

    group: list[FieldRow]
    count: int

    def compare_key(self) -> tuple:
        return tuple(fr.row_id for fr in self.group)

    def to_json(self) -> dict:
        return {"group": [fr.to_json() for fr in self.group], "count": self.count}


def merge_group_counts(a: list[GroupCount], b: list[GroupCount], limit: int) -> list[GroupCount]:
    """Sorted merge summing counts of equal groups, capped at limit
    (reference executor.go mergeGroupCounts :1195)."""
    limit = min(limit, len(a) + len(b))
    out: list[GroupCount] = []
    i = j = 0
    while i < len(a) and j < len(b) and len(out) < limit:
        ka, kb = a[i].compare_key(), b[j].compare_key()
        if ka < kb:
            out.append(a[i])
            i += 1
        elif ka > kb:
            out.append(b[j])
            j += 1
        else:
            out.append(GroupCount(a[i].group, a[i].count + b[j].count))
            i += 1
            j += 1
    while i < len(a) and len(out) < limit:
        out.append(a[i])
        i += 1
    while j < len(b) and len(out) < limit:
        out.append(b[j])
        j += 1
    return out


@dataclass
class SignedRow:
    """Placeholder for signed BSI row results (used by later versions of the
    reference; kept for API-shape completeness)."""

    pos: Any = None
    neg: Any = None


def result_to_json(result: Any) -> Any:
    """Encode an executor result the way the HTTP layer does
    (reference http/handler.go query response encoding)."""
    from pilosa_tpu_torch.core.row import Row

    if result is None:
        return None
    if isinstance(result, Row):
        # lint: allow-hot-serialize(legacy dict encoder kept as the byte-compat oracle; the serving path rides utils/fastjson)
        out: dict[str, Any] = {"columns": result.columns().tolist()}
        if result.keys:
            out = {"keys": result.keys, "columns": []}
        if result.attrs:
            out["attrs"] = result.attrs
        return out
    if isinstance(result, bool):
        return result
    if isinstance(result, int):
        return result
    if isinstance(result, (ValCount, PairsField, PairField, RowIDs)):
        return result.to_json()
    if isinstance(result, list):
        return [result_to_json(r) for r in result]
    if isinstance(result, GroupCount):
        return result.to_json()
    return result
