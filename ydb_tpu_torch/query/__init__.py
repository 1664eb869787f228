from ydb_tpu_torch.query.engine import QueryEngine, QueryError  # noqa: F401
