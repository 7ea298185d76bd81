"""Side stores: attributes and key translation (reference attr.go, translate.go).

The reference backs these with BoltDB (reference boltdb/attrstore.go,
boltdb/translate.go); here they are sqlite3 (in the standard library), with
the same interfaces: attr stores map row/column ids to small attribute
dicts, translate stores map string keys to monotonically-assigned uint64
ids and back.
"""

from pilosa_tpu_torch.store.attrs import AttrStore
from pilosa_tpu_torch.store.translate import TranslateStore
