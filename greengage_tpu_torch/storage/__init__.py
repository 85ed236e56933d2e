"""Storage — the port's table stores (a database directory's block files
and manifest, or in memory), TEXT dictionaries and the host codec."""

from greengage_tpu_torch.storage.table_store import (  # noqa: F401
    MemoryTableStore, TableStore)
