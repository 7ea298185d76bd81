"""CPU backend: per-shard bitmap-call evaluation on host fragments.

This is the oracle the TPU backend is differential-tested against
(SURVEY.md §7 step 3): it evaluates the per-shard call tree exactly as the
reference's executeBitmapCallShard recursion (reference executor.go:651-677)
using the numpy roaring engine.
"""

from __future__ import annotations

import datetime as dt
from typing import Optional

from pilosa_tpu_torch.core.index import EXISTENCE_FIELD_NAME
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.timequantum import parse_time, views_by_time_range
from pilosa_tpu_torch.core.view import VIEW_STANDARD, bsi_view_name
from pilosa_tpu_torch.pql.ast import BETWEEN, Call, Condition, EQ, GT, GTE, LT, LTE, NEQ


class QueryError(Exception):
    pass


class NotFoundError(QueryError):
    """Index/field genuinely absent. Distinguished structurally so the
    cluster's missed-DDL repair can tell 'peer lacks schema' apart from
    'object does not exist' without string matching (ADVICE r2 #4); the
    HTTP error body carries code='not-found' while the status stays the
    reference's 400."""


class CPUBackend:
    def __init__(self, holder):
        self.holder = holder

    # -- helpers ----------------------------------------------------------

    def _index(self, index: str):
        idx = self.holder.index(index)
        if idx is None:
            raise NotFoundError(f"index not found: {index}")
        return idx

    def _field(self, index: str, name: str):
        f = self._index(index).field(name)
        if f is None:
            raise NotFoundError(f"field not found: {name}")
        return f

    def _fragment(self, index: str, field: str, view: str, shard: int):
        f = self._index(index).field(field)
        if f is None:
            return None
        v = f.view(view)
        if v is None:
            return None
        return v.fragment(shard)

    # -- dispatch (reference executor.go:651-677) --------------------------

    def bitmap_call_shard(self, index: str, c: Call, shard: int) -> Row:
        if c.name in ("Row", "Range"):
            return self._row_shard(index, c, shard)
        if c.name == "Difference":
            return self._nary(index, c, shard, "difference", empty_ok=False)
        if c.name == "Intersect":
            return self._nary(index, c, shard, "intersect", empty_ok=False)
        if c.name == "Union":
            return self._nary(index, c, shard, "union", empty_ok=True)
        if c.name == "Xor":
            return self._nary(index, c, shard, "xor", empty_ok=True)
        if c.name == "Not":
            return self._not_shard(index, c, shard)
        if c.name == "Shift":
            return self._shift_shard(index, c, shard)
        if c.name == "All":
            return self._all_shard(index, shard)
        raise QueryError(f"unknown call: {c.name}")

    def count_shard(self, index: str, c: Call, shard: int) -> int:
        """Seam for device backends to fuse count without materializing.

        The host path short-circuits Count(Intersect(a, b)) through
        container-level intersection_count (reference
        roaring.IntersectionCount, roaring/roaring.go:570) — counting
        membership masks directly instead of building the result row."""
        if c.name == "Intersect" and len(c.children) == 2 and not c.args:
            a = self.bitmap_call_shard(index, c.children[0], shard)
            b = self.bitmap_call_shard(index, c.children[1], shard)
            return a.intersection_count(b)
        return self.bitmap_call_shard(index, c, shard).count()

    def _nary(self, index: str, c: Call, shard: int, op: str, empty_ok: bool) -> Row:
        if not c.children and not empty_ok:
            raise QueryError(f"empty {c.name} query is currently not supported")
        out: Optional[Row] = None
        for child in c.children:
            row = self.bitmap_call_shard(index, child, shard)
            out = row if out is None else getattr(out, op)(row)
        return out if out is not None else Row()

    def _not_shard(self, index: str, c: Call, shard: int) -> Row:
        if len(c.children) != 1:
            raise QueryError("Not() requires a single row input")
        idx = self._index(index)
        if idx.existence_field() is None:
            raise QueryError(f"index does not support existence tracking: {index}")
        frag = self._fragment(index, EXISTENCE_FIELD_NAME, VIEW_STANDARD, shard)
        existence = frag.row(0) if frag is not None else Row()
        row = self.bitmap_call_shard(index, c.children[0], shard)
        return existence.difference(row)

    def _all_shard(self, index: str, shard: int) -> Row:
        """All columns with any set bit, via the existence field."""
        idx = self._index(index)
        if idx.existence_field() is None:
            raise QueryError(f"index does not support existence tracking: {index}")
        frag = self._fragment(index, EXISTENCE_FIELD_NAME, VIEW_STANDARD, shard)
        return frag.row(0) if frag is not None else Row()

    def _shift_shard(self, index: str, c: Call, shard: int) -> Row:
        n, _ = c.int_arg("n")
        if n < 0:
            raise QueryError("cannot shift by negative values")
        if len(c.children) != 1:
            raise QueryError("Shift() requires a single row input")
        row = self.bitmap_call_shard(index, c.children[0], shard)
        # n=0 (or missing) returns the row unchanged (reference row.go Shift).
        for _ in range(n):
            row = row.shift()
        return row

    # -- Row / Range (reference executor.go:1441-1530) --------------------

    def _row_shard(self, index: str, c: Call, shard: int) -> Row:
        cond_args = [(k, v) for k, v in c.args.items() if isinstance(v, Condition)]
        if cond_args:
            return self._row_bsi_shard(index, c, shard, cond_args)

        field_name = c.field_arg()
        f = self._field(index, field_name)
        row_id, ok = c.uint64_arg(field_name)
        if not ok:
            raise QueryError("Row() must specify row")

        from_t = to_t = None
        if "from" in c.args:
            from_t = parse_time(c.args["from"])
        if "to" in c.args:
            to_t = parse_time(c.args["to"])

        if c.name == "Row" and from_t is None and to_t is None:
            frag = self._fragment(index, field_name, VIEW_STANDARD, shard)
            return frag.row(row_id) if frag is not None else Row()

        if not f.options.time_quantum:
            return Row()
        if from_t is None:
            from_t = dt.datetime(1, 1, 1)
        if to_t is None:
            to_t = dt.datetime.utcnow() + dt.timedelta(days=1)
        out = Row()
        for view in views_by_time_range(VIEW_STANDARD, from_t, to_t, f.options.time_quantum):
            frag = self._fragment(index, field_name, view, shard)
            if frag is not None:
                out = out.union(frag.row(row_id))
        return out

    def _row_bsi_shard(self, index: str, c: Call, shard: int, cond_args) -> Row:
        """reference executor.go executeRowBSIGroupShard :1533."""
        if len(c.args) > 1:
            raise QueryError("Row(): too many arguments")
        field_name, cond = cond_args[0]
        f = self._field(index, field_name)
        opts = f.bsi_group()
        frag = self._fragment(index, field_name, bsi_view_name(field_name), shard)

        if cond.op == NEQ and cond.value is None:
            # != null  ->  notNull
            return frag.not_null() if frag is not None else Row()

        if cond.op == BETWEEN:
            predicates = cond.int_slice_value()
            if len(predicates) != 2:
                raise QueryError("Row(): BETWEEN condition requires exactly two integer values")
            lo, hi = predicates
            base_lo, base_hi, out_of_range = self._base_value_between(f, lo, hi)
            if out_of_range:
                return Row()
            if frag is None:
                return Row()
            if lo <= opts.min and hi >= opts.max:
                return frag.not_null()
            return frag.range_between(opts.bit_depth, base_lo, base_hi)

        if not isinstance(cond.value, int) or isinstance(cond.value, bool):
            raise QueryError("Row(): conditions only support integer values")
        value = cond.value
        base_value, out_of_range = self._base_value(f, cond.op, value)
        if out_of_range and cond.op != NEQ:
            return Row()
        if frag is None:
            return Row()
        # Fully-encompassing LT/GT returns all not-null
        # (reference executor.go:1650-1656).
        if (
            (cond.op == LT and value > opts.max)
            or (cond.op == LTE and value >= opts.max)
            or (cond.op == GT and value < opts.min)
            or (cond.op == GTE and value <= opts.min)
        ):
            return frag.not_null()
        if out_of_range and cond.op == NEQ:
            return frag.not_null()
        return frag.range_op(cond.op, opts.bit_depth, base_value)

    @staticmethod
    def _base_value(f, op: str, value: int):
        """reference field.go bsiGroup.baseValue :1584."""
        opts = f.options
        vmin, vmax = f.bit_depth_min(), f.bit_depth_max()
        base_value = 0
        if op in (GT, GTE):
            if value > vmax:
                return 0, True
            if value > vmin:
                base_value = value - opts.base
        elif op in (LT, LTE):
            if value < vmin:
                return 0, True
            if value > vmax:
                base_value = vmax - opts.base
            else:
                base_value = value - opts.base
        elif op in (EQ, NEQ):
            if value < vmin or value > vmax:
                return 0, True
            base_value = value - opts.base
        return base_value, False

    @staticmethod
    def _base_value_between(f, lo: int, hi: int):
        """reference field.go bsiGroup.baseValueBetween :1612."""
        opts = f.options
        vmin, vmax = f.bit_depth_min(), f.bit_depth_max()
        if hi < vmin or lo > vmax:
            return 0, 0, True
        lo = max(lo, vmin)
        hi = min(hi, vmax)
        return lo - opts.base, hi - opts.base, False
