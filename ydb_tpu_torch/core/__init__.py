from ydb_tpu_torch.core import dtypes
from ydb_tpu_torch.core.block import HostBlock
from ydb_tpu_torch.core.schema import Column, Schema

__all__ = ["dtypes", "HostBlock", "Column", "Schema"]
