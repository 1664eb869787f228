from ydb_tpu_torch.cluster.router import ShardedCluster  # noqa: F401
