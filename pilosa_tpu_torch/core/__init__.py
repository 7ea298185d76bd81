"""Core storage hierarchy: Holder -> Index -> Field -> view -> fragment.

Same data model as the reference (reference holder.go, index.go, field.go,
view.go, fragment.go): a process-wide Holder owns named Indexes; an Index
owns typed Fields (set/int/time/mutex/bool); a Field owns views ("standard",
time-quantum views, BSI group views); a view owns one fragment per shard;
a fragment stores a roaring bitmap whose position space is
row_id * SHARD_WIDTH + (column_id % SHARD_WIDTH).

Durability is per fragment: a snapshot file in the byte-compatible Pilosa
roaring format plus an appended op-log WAL, rewritten when the op count
exceeds a threshold (reference fragment.go:84 MaxOpN, :2296 snapshot).
"""

from pilosa_tpu_torch.core.field import Field, FieldOptions
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.index import Index, IndexOptions
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.core.view import View
