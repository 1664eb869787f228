from ydb_tpu_torch.scheme.catalog import Catalog  # noqa: F401
