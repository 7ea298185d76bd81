"""PQL — the Pilosa Query Language.

Hand-rolled recursive-descent parser equivalent to the reference's PEG
grammar (reference pql/pql.peg, generated parser pql/pql.peg.go), producing
the same AST shape (reference pql/ast.go: Query / Call{Name, Args, Children}
/ Condition).
"""

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
    canonical_key,
    canonicalize,
)
from pilosa_tpu_torch.pql.parser import ParseError, parse_string
