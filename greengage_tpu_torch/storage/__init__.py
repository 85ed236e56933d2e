"""Storage — the port's table stores (a database directory's block files
and manifest, or in memory), their block cache, TEXT dictionaries and the
host codec."""

from greengage_tpu_torch.storage.manifest import Manifest  # noqa: F401
from greengage_tpu_torch.storage.table_store import (  # noqa: F401
    MemoryTableStore, TableStore)
