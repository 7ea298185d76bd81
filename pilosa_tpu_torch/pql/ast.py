"""PQL AST: Query, Call, Condition (reference pql/ast.go:27,263,482)."""

from __future__ import annotations

from typing import Any, Optional

# Condition operator tokens (reference pql/token.go; string forms used in
# error messages and Condition.String()).
ILLEGAL = "ILLEGAL"
EQ = "=="
NEQ = "!="
LT = "<"
LTE = "<="
GT = ">"
GTE = ">="
BETWEEN = "><"


class Condition:
    """A comparison attached to a field arg, e.g. x > 5 (reference pql/ast.go:482)."""

    __slots__ = ("op", "value")

    def __init__(self, op: str, value: Any):
        self.op = op
        self.value = value

    def int_slice_value(self) -> list[int]:
        """BETWEEN bounds as ints (reference Condition.IntSliceValue :495)."""
        if not isinstance(self.value, list):
            raise ValueError(f"expected list value for condition, got {self.value!r}")
        out = []
        for v in self.value:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"expected int in condition value, got {v!r}")
            out.append(v)
        return out

    def string_with_subj(self, subj: str) -> str:
        if self.op == BETWEEN and isinstance(self.value, list) and len(self.value) == 2:
            return f"{self.value[0]} <= {subj} <= {self.value[1]}"
        return f"{subj} {self.op} {self.value}"

    def __repr__(self) -> str:
        return f"Condition({self.op!r}, {self.value!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Condition)
            and self.op == other.op
            and self.value == other.value
        )


RESERVED_FIELDS = ("_row", "_col", "_start", "_end", "_timestamp", "_field")


def is_reserved_arg(name: str) -> bool:
    """reference pql/ast.go IsReservedArg."""
    return name.startswith("_") or name in ("from", "to")


class Call:
    """One function call in the AST (reference pql/ast.go:263)."""

    __slots__ = ("name", "args", "children", "cached", "has_str_args")

    def __init__(
        self,
        name: str,
        args: Optional[dict[str, Any]] = None,
        children: Optional[list["Call"]] = None,
    ):
        self.name = name
        self.args = args if args is not None else {}
        self.children = children if children is not None else []
        # True only on trees owned by the parse cache (set at cache
        # insertion): such objects are pinned and identity-stable, which
        # is what makes id-keyed memoization (pair-plan cache) sound.
        # Copies and translated rewrites are always False.
        self.cached = False
        # Whether this subtree carries any str/bool arg — the only
        # values key translation can rewrite or reject. Defaults True
        # (conservative: always translate); the parser computes it
        # precisely at cache insertion so pure-integer trees skip the
        # per-request translation walk entirely on keyless indexes.
        self.has_str_args = True

    def copy(self) -> "Call":
        """Structural copy for paths that MUST mutate (e.g. TopN pass-2
        pins candidate ids). Parsed trees are otherwise immutable and
        SHARED — parse-cache hits return the same objects to concurrent
        requests, and key translation is copy-on-write
        (executor._translate_call) — so never mutate a parsed Call
        without cloning it first. Conditions are immutable post-parse
        (ops/values never rewritten) and shared; nested Calls in args
        (GroupBy filter=) are copied."""
        args = {
            k: (v.copy() if isinstance(v, Call) else v)
            for k, v in self.args.items()
        }
        return Call(self.name, args, [c.copy() for c in self.children])

    # -- typed arg accessors (reference pql/ast.go:297-393) ---------------

    def field_arg(self) -> str:
        """The non-reserved key holding field=rowID (reference Call.FieldArg)."""
        for arg in self.args:
            if not is_reserved_arg(arg):
                return arg
        raise ValueError("no field argument specified")

    def bool_arg(self, key: str) -> tuple[bool, bool]:
        """Returns (value, found); raises if present but not a bool."""
        if key not in self.args:
            return False, False
        v = self.args[key]
        if not isinstance(v, bool):
            raise ValueError(f"could not convert {v!r} to bool in {self.name}")
        return v, True

    def uint64_arg(self, key: str) -> tuple[int, bool]:
        if key not in self.args:
            return 0, False
        v = self.args[key]
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(f"could not convert {v!r} to uint64 in {self.name}")
        return v, True

    def int_arg(self, key: str) -> tuple[int, bool]:
        return self.uint64_arg(key)

    def string_arg(self, key: str) -> tuple[str, bool]:
        if key not in self.args:
            return "", False
        v = self.args[key]
        if not isinstance(v, str):
            raise ValueError(f"could not convert {v!r} to string in {self.name}")
        return v, True

    def uint64_slice_arg(self, key: str) -> tuple[list[int], bool]:
        if key not in self.args:
            return [], False
        v = self.args[key]
        if not isinstance(v, list):
            raise ValueError(f"could not convert {v!r} to []uint64 in {self.name}")
        return list(v), True

    def clone(self) -> "Call":
        return self.copy()

    def supports_shards(self) -> bool:
        """Whether the call fans out per shard (used by executor option
        validation, reference executor.go needsShards equivalent)."""
        return self.name in (
            "Row", "Range", "Union", "Intersect", "Xor", "Difference", "Not",
            "Count", "Shift", "All",
        )

    # -- stringification (reference Call.String, used in error paths) -----

    def __repr__(self) -> str:
        return self.to_string()

    def to_string(self) -> str:
        parts = []
        for child in self.children:
            parts.append(child.to_string())
        for key in sorted(self.args):
            val = self.args[key]
            if isinstance(val, Condition):
                parts.append(val.string_with_subj(key))
            else:
                parts.append(f"{key}={_fmt_val(val)}")
        return f"{self.name}({', '.join(parts)})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Call)
            and self.name == other.name
            and self.args == other.args
            and self.children == other.children
        )


#: Set operations whose children commute: reordering the inputs cannot
#: change the result, so canonicalization may sort them into one shared
#: spelling. Difference/Not are order-sensitive and MUST stay out — an
#: entry keyed on a sorted Difference would serve A\B for B\A.
COMMUTATIVE_CALLS = frozenset(("Intersect", "Union", "Xor"))


def canonicalize(c: Call) -> Call:
    """Structural canonical form for result-cache keying (ISSUE r12):
    syntactically different but equivalent queries share one spelling.
    Commutative set-op children (Intersect/Union/Xor) sort by their own
    canonical string; everything else keeps order. Copy-on-write like
    executor._translate_call: returns `c` UNCHANGED when it is already
    canonical, so the common single-Row/sorted case allocates nothing.
    Literal normalization rides Call.to_string(): args print sorted by
    key with one deterministic value formatting, so `Row(f=3)` and
    `Row( f = 3 )` already collapse at the string layer."""
    new_children = None
    for i, child in enumerate(c.children):
        nc = canonicalize(child)
        if nc is not child:
            if new_children is None:
                new_children = list(c.children)
            new_children[i] = nc
    if c.name in COMMUTATIVE_CALLS and len(c.children) > 1:
        kids = new_children if new_children is not None else list(c.children)
        ordered = sorted(kids, key=Call.to_string)
        if ordered != kids or new_children is not None:
            new_children = ordered
    # Nested calls in args (GroupBy filter=) canonicalize too.
    new_args = None
    for k, v in c.args.items():
        if isinstance(v, Call):
            nv = canonicalize(v)
            if nv is not v:
                if new_args is None:
                    new_args = dict(c.args)
                new_args[k] = nv
    if new_children is None and new_args is None:
        return c
    return Call(
        c.name,
        new_args if new_args is not None else dict(c.args),
        new_children if new_children is not None else list(c.children),
    )


def canonical_key(c: Call) -> str:
    """The cache-key spelling of a call: canonical tree, stringified
    (children first, args sorted — Call.to_string). Equivalent queries
    map to one key; inequivalent ones (Difference order, distinct
    literals) never collide beyond what PQL semantics guarantee."""
    return canonicalize(c).to_string()


def shape_key(c: Call) -> str:
    """Structure-only shape fingerprint for per-shape cost accounting
    (ISSUE 18, /debug/workload): call names, arg keys, and FIELD names
    survive; every literal (row ids, condition bounds, string values)
    collapses to `?`. `Count(Row(f=3))` and `Count(Row(f=99))` are one
    shape; `Count(Row(g=3))` is another; `Difference(a,b)` never folds
    with `Difference(b,a)` (children keep order — shape is structure,
    and Difference's structure is ordered).

    Cardinality contract (the pilint metric-tags rationale for the
    `shape` tag key): the key population is bounded by the parser's call
    vocabulary x operator-created field names x arg-key spellings —
    request CONTENT (the unbounded part) never survives into the key."""
    parts = [shape_key(ch) for ch in c.children]
    for k in sorted(c.args):
        v = c.args[k]
        if isinstance(v, Call):
            parts.append(f"{k}={shape_key(v)}")
        elif isinstance(v, Condition):
            # The operator is structure (a < scan and a == probe are
            # different device programs); the bound is a literal.
            parts.append(f"{k}{v.op}?")
        elif k in ("field", "_field") and isinstance(v, str):
            # Field names are schema-bounded structure, not content.
            parts.append(f"{k}={v}")
        else:
            # Non-reserved keys ARE field names (field=rowID spelling):
            # keep the key, strip the literal. Reserved args keep the
            # key too — which options a call uses is structural.
            parts.append(f"{k}=?")
    return f"{c.name}({', '.join(parts)})"


def _fmt_val(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        # Escape so Call.to_string() round-trips through the parser — the
        # cluster RPC layer re-parses serialized calls on peers.
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ",".join(_fmt_val(x) for x in v) + "]"
    if isinstance(v, Call):
        return v.to_string()
    return str(v)


class Query:
    """A parsed PQL query: a list of top-level calls (reference pql/ast.go:27)."""

    __slots__ = ("calls",)

    def __init__(self, calls: Optional[list[Call]] = None):
        self.calls = calls if calls is not None else []

    def copy(self) -> "Query":
        return Query([c.copy() for c in self.calls])

    def write_call_n(self) -> int:
        """Number of mutating calls (reference Query.WriteCallN)."""
        return sum(
            1
            for c in self.calls
            if c.name in ("Set", "Clear", "SetRowAttrs", "SetColumnAttrs")
        )

    def __repr__(self) -> str:
        return "\n".join(c.to_string() for c in self.calls)
