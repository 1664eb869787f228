from ydb_tpu_torch.storage.mvcc import Snapshot, WriteVersion
from ydb_tpu_torch.storage.table import ColumnTable

__all__ = ["ColumnTable", "Snapshot", "WriteVersion"]
