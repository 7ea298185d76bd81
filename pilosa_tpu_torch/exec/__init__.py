"""Query execution engine.

The executor evaluates a parsed PQL query against the holder through a
backend: the CUDA device backend in exec/cuda.py (the default), or the CPU
oracle in exec/cpu.py, whose per-shard results fold through the
reference's mapReduce structure (reference executor.go:2460).
"""

from pilosa_tpu_torch.exec.executor import Executor, ExecOptions
from pilosa_tpu_torch.exec.result import (
    GroupCount,
    FieldRow,
    PairsField,
    RowIDs,
    SignedRow,
    ValCount,
)
