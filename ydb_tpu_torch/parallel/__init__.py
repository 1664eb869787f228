from ydb_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from ydb_tpu_torch.parallel.shuffle import DistributedAgg  # noqa: F401
