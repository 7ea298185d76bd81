"""Recursive-descent PQL parser with backtracking.

Faithful to the reference PEG grammar (reference pql/pql.peg): each method
corresponds to a grammar rule; ordered-choice alternatives are tried in
grammar order with position backtracking, so inputs like `Range(f > 5)`
fall through the special Range form to the generic-call rule exactly as the
PEG does.
"""

from __future__ import annotations

import re
import threading
from typing import Any

from pilosa_tpu_torch.pql.ast import (
    BETWEEN,
    EQ,
    GT,
    GTE,
    LT,
    LTE,
    NEQ,
    Call,
    Condition,
    Query,
)

DUPLICATE_ARG_ERROR = "duplicate argument provided"


class ParseError(Exception):
    def __init__(self, msg: str, pos: int = -1):
        super().__init__(msg if pos < 0 else f"{msg} at position {pos}")
        self.pos = pos


class _Backtrack(Exception):
    """Internal: alternative failed, try the next one."""


_IDENT_RE = re.compile(r"[A-Za-z][A-Za-z0-9]*")
_FIELD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]*")
_UINT_RE = re.compile(r"[1-9][0-9]*|0")
_INT_RE = re.compile(r"-?[1-9][0-9]*|0")
_NUM_RE = re.compile(r"-?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)")
_TIMESTAMP_RE = re.compile(r"[0-9]{4}-[01][0-9]-[0-3][0-9]T[0-9]{2}:[0-9]{2}")
_BARE_STRING_RE = re.compile(r"[A-Za-z0-9:_-]+")
_RESERVED_FIELDS = ("_row", "_col", "_start", "_end", "_timestamp", "_field")

_SPECIAL_FORMS = (
    "Set",
    "SetRowAttrs",
    "SetColumnAttrs",
    "Clear",
    "ClearRow",
    "Store",
    "TopN",
    "Rows",
    "Range",
)


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    # -- low-level helpers ------------------------------------------------

    def _sp(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n":
            self.pos += 1

    def _lit(self, s: str) -> None:
        if not self.text.startswith(s, self.pos):
            raise _Backtrack()
        self.pos += len(s)

    def _re(self, pattern: re.Pattern) -> str:
        m = pattern.match(self.text, self.pos)
        if m is None:
            raise _Backtrack()
        self.pos = m.end()
        return m.group(0)

    def _open(self) -> None:
        self._lit("(")
        self._sp()

    def _close(self) -> None:
        self._lit(")")
        self._sp()

    def _comma(self) -> None:
        self._sp()
        self._lit(",")
        self._sp()

    def _try(self, fn, *args):
        """Run fn, restoring position on backtrack; returns (ok, value)."""
        saved = self.pos
        try:
            return True, fn(*args)
        except _Backtrack:
            self.pos = saved
            return False, None

    # -- grammar rules ----------------------------------------------------

    def parse(self) -> Query:
        q = Query()
        self._sp()
        while self.pos < len(self.text):
            ok, call = self._try(self._call)
            if not ok:
                raise ParseError(
                    f"parse error near {self.text[self.pos:self.pos+20]!r}", self.pos
                )
            q.calls.append(call)
            self._sp()
        return q

    def _call(self) -> Call:
        for name in _SPECIAL_FORMS:
            ok, call = self._try(self._special_form, name)
            if ok:
                return call
        return self._generic_call()

    def _special_form(self, name: str) -> Call:
        self._lit(name)
        call = Call(name)
        self._open()
        if name == "Set":
            self._col(call)
            self._comma()
            self._args(call)
            ok, _ = self._try(self._set_timestamp, call)
            self._close()
        elif name == "SetRowAttrs":
            self._posfield(call)
            self._comma()
            self._row(call)
            self._comma()
            self._args(call)
            self._close()
        elif name == "SetColumnAttrs":
            self._col(call)
            self._comma()
            self._args(call)
            self._close()
        elif name == "Clear":
            self._col(call)
            self._comma()
            self._args(call)
            self._close()
        elif name == "ClearRow":
            self._arg(call)
            self._close()
        elif name == "Store":
            child = self._call_rule()
            call.children.append(child)
            self._comma()
            self._arg(call)
            self._close()
        elif name in ("TopN", "Rows"):
            self._posfield(call)
            ok, _ = self._try(self._comma_allargs, call)
            self._close()
        elif name == "Range":
            self._range_form(call)
        else:  # pragma: no cover
            raise _Backtrack()
        return call

    def _call_rule(self) -> Call:
        self._sp()
        return self._call()

    def _set_timestamp(self, call: Call) -> None:
        self._comma()
        ts = self._timestampfmt()
        call.args["_timestamp"] = ts

    def _comma_allargs(self, call: Call) -> None:
        self._comma()
        self._allargs(call)

    def _range_form(self, call: Call) -> None:
        """Range(field=value, from=ts, to=ts) (reference pql.peg Range rule)."""
        field = self._field_name()
        self._sp()
        self._lit("=")
        self._sp()
        val = self._value(call, field)
        call.args[field] = val
        self._comma()
        ok, _ = self._try(self._lit, "from=")
        ts = self._timestampfmt()
        call.args["from"] = ts
        self._comma()
        ok, _ = self._try(self._lit, "to=")
        self._sp()
        ts = self._timestampfmt()
        call.args["to"] = ts
        self._close()

    def _generic_call(self) -> Call:
        name = self._re(_IDENT_RE)
        call = Call(name)
        self._open()
        self._allargs(call)
        ok, _ = self._try(self._comma)
        self._close()
        return call

    def _allargs(self, call: Call) -> None:
        # allargs <- Call (comma Call)* (comma args)? / args / sp
        ok, child = self._try(self._call)
        if ok:
            call.children.append(child)
            while True:
                saved = self.pos
                try:
                    self._comma()
                    child = self._call()
                    call.children.append(child)
                except _Backtrack:
                    self.pos = saved
                    break
            saved = self.pos
            try:
                self._comma()
                self._args(call)
            except _Backtrack:
                self.pos = saved
            return
        ok, _ = self._try(self._args, call)
        if ok:
            return
        self._sp()

    def _args(self, call: Call) -> None:
        self._arg(call)
        saved = self.pos
        try:
            self._comma()
            self._args(call)
        except _Backtrack:
            self.pos = saved
        self._sp()

    def _arg(self, call: Call) -> None:
        # arg <- field '=' value / field COND value / conditional
        saved = self.pos
        try:
            field = self._field_name()
            self._sp()
            self._lit("=")
            # Guard: '==' is the EQ condition, not assignment.
            if self.text.startswith("=", self.pos):
                raise _Backtrack()
            self._sp()
            val = self._value(call, field)
            self._set_arg(call, field, val)
            return
        except _Backtrack:
            self.pos = saved
        try:
            field = self._field_name()
            self._sp()
            op = self._cond_op()
            self._sp()
            val = self._value(call, field)
            self._set_arg(call, field, Condition(op, val))
            return
        except _Backtrack:
            self.pos = saved
        self._conditional(call)

    def _cond_op(self) -> str:
        for lit, op in (
            ("><", BETWEEN),
            ("<=", LTE),
            (">=", GTE),
            ("==", EQ),
            ("!=", NEQ),
            ("<", LT),
            (">", GT),
        ):
            ok, _ = self._try(self._lit, lit)
            if ok:
                return op
        raise _Backtrack()

    def _conditional(self, call: Call) -> None:
        """condint condLT condfield condLT condint, e.g. 4 < x <= 9."""
        low = int(self._re(_INT_RE))
        self._sp()
        op1 = self._cond_lt()
        field = self._re(_FIELD_RE)
        self._sp()
        op2 = self._cond_lt()
        high = int(self._re(_INT_RE))
        self._sp()
        if op1 == "<":
            low += 1
        if op2 == "<":
            high -= 1
        self._set_arg(call, field, Condition(BETWEEN, [low, high]))

    def _cond_lt(self) -> str:
        ok, _ = self._try(self._lit, "<=")
        if ok:
            self._sp()
            return "<="
        self._lit("<")
        self._sp()
        return "<"

    def _set_arg(self, call: Call, field: str, val: Any) -> None:
        # Duplicate args are a hard error, not a backtrack
        # (reference pql/ast.go validateArgField panic -> parse error).
        if field in call.args:
            raise ParseError(f"{DUPLICATE_ARG_ERROR}: {field}")
        call.args[field] = val

    # -- values -----------------------------------------------------------

    def _value(self, call: Call, field: str) -> Any:
        ok, _ = self._try(self._lit, "[")
        if ok:
            self._sp()
            # list <- item (comma list)? — at least one item (reference
            # pql.peg list rule; '[]' is a parse error there too).
            items: list[Any] = [self._item(call)]
            while True:
                saved = self.pos
                try:
                    self._comma()
                    items.append(self._item(call))
                except _Backtrack:
                    self.pos = saved
                    break
            self._sp()
            self._lit("]")
            self._sp()
            return items
        return self._item(call)

    def _item(self, call: Call) -> Any:
        # Ordered per the grammar's item rule.
        for word, value in (("null", None), ("true", True), ("false", False)):
            saved = self.pos
            try:
                self._lit(word)
                # The grammar's lookahead is &(comma / sp close) — ')' only,
                # NOT ']': inside a list, "null]" falls through to the
                # bare-string rule (reference pql.peg item rule).
                if not self._at_item_boundary(allow_rbrack=False):
                    raise _Backtrack()
                return value
            except _Backtrack:
                self.pos = saved
        ok, ts = self._try(self._timestampfmt)
        if ok:
            return ts
        saved = self.pos
        ok, num = self._try(self._re, _NUM_RE)
        if ok:
            # Numbers must not be a prefix of a bare string (e.g. "1a").
            if self._at_item_boundary():
                return float(num) if "." in num else int(num)
            self.pos = saved
        # Nested call used as a value, e.g. field=Row(...)
        saved = self.pos
        try:
            ident = self._re(_IDENT_RE)
            self._open()
            sub = Call(ident)
            self._allargs(sub)
            ok, _ = self._try(self._comma)
            self._close()
            return sub
        except _Backtrack:
            self.pos = saved
        ok, bare = self._try(self._re, _BARE_STRING_RE)
        if ok:
            return bare
        ok, s = self._try(self._quoted, '"')
        if ok:
            return s
        ok, s = self._try(self._quoted, "'")
        if ok:
            return s
        raise _Backtrack()

    def _at_item_boundary(self, allow_rbrack: bool = True) -> bool:
        """After an item we must see a comma, ')' or ']' (possibly via sp)."""
        i = self.pos
        while i < len(self.text) and self.text[i] in " \t\n":
            i += 1
        boundary = ",)]" if allow_rbrack else ",)"
        return i >= len(self.text) or self.text[i] in boundary

    def _quoted(self, q: str) -> str:
        self._lit(q)
        out = []
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "\\" and self.pos + 1 < len(self.text):
                nxt = self.text[self.pos + 1]
                if nxt in (q, "\\"):
                    out.append(nxt)
                    self.pos += 2
                    continue
            if ch == q:
                self.pos += 1
                return "".join(out)
            out.append(ch)
            self.pos += 1
        raise _Backtrack()

    def _timestampfmt(self) -> str:
        for q in ('"', "'"):
            saved = self.pos
            try:
                self._lit(q)
                ts = self._re(_TIMESTAMP_RE)
                self._lit(q)
                return ts
            except _Backtrack:
                self.pos = saved
        return self._re(_TIMESTAMP_RE)

    # -- fields and positional args ---------------------------------------

    def _field_name(self) -> str:
        for r in _RESERVED_FIELDS:
            ok, _ = self._try(self._lit, r)
            if ok:
                return r
        return self._re(_FIELD_RE)

    def _posfield(self, call: Call) -> None:
        name = self._re(_FIELD_RE)
        call.args["_field"] = name
        self._sp()

    def _col(self, call: Call) -> None:
        self._pos_arg(call, "_col")

    def _row(self, call: Call) -> None:
        self._pos_arg(call, "_row")

    def _pos_arg(self, call: Call, key: str) -> None:
        ok, num = self._try(self._re, _UINT_RE)
        if ok:
            call.args[key] = int(num)
            self._sp()
            return
        for q in ("'", '"'):
            ok, s = self._try(self._quoted, q)
            if ok:
                call.args[key] = s
                self._sp()
                return
        raise _Backtrack()


_parse_cache: dict[str, Query] = {}
_parse_lock = threading.Lock()
_PARSE_CACHE_MAX = 512
_PARSE_CACHE_MAX_LEN = 4096  # don't cache giant one-off request bodies


def parse_string(text: str) -> Query:
    """Parse a PQL string into a Query (reference pql/parser.go:49).

    Parses are cached by query text (LRU): serving workloads repeat a
    small set of query strings, and the backtracking parser costs ~400 us
    per call tree — ~6.5 ms of a 16-Count request before caching. Hits
    return the SHARED tree: parsed Calls are immutable by contract —
    key translation is copy-on-write (executor._translate_call) and
    mutating paths clone first (e.g. TopN pass 2) — so no per-request
    structural copy is needed."""
    cacheable = len(text) <= _PARSE_CACHE_MAX_LEN
    if cacheable:
        with _parse_lock:
            q = _parse_cache.get(text)
            if q is not None:
                _parse_cache[text] = _parse_cache.pop(text)  # LRU touch
        if q is not None:
            return q
    q = Parser(text).parse()
    if cacheable:
        def mark(c) -> bool:
            c.cached = True
            has = any(isinstance(v, (str, bool)) for v in c.args.values())
            for ch in c.children:
                has = mark(ch) or has
            for v in c.args.values():
                if isinstance(v, Call):
                    has = mark(v) or has
            c.has_str_args = has
            return has
        for c in q.calls:
            mark(c)
        with _parse_lock:
            _parse_cache.pop(text, None)
            _parse_cache[text] = q
            while len(_parse_cache) > _PARSE_CACHE_MAX:
                _parse_cache.pop(next(iter(_parse_cache)))
    return q
