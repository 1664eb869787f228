from ydb_tpu_torch.sql.parser import parse  # noqa: F401
