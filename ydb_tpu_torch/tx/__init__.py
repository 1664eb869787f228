from ydb_tpu_torch.tx.coordinator import Coordinator  # noqa: F401
from ydb_tpu_torch.tx.session import (  # noqa: F401
    Session, Transaction, TxAborted, TxCommitTorn,
)
