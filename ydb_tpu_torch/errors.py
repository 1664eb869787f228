"""Errors of the port."""


class NotPorted(NotImplementedError):
    """A path of ``ydb_tpu`` that this package does not run yet.

    Raised instead of quietly taking another path: the port either runs
    a statement the way the reference does, on the device it was given,
    or says which part is missing."""

    def __init__(self, what: str):
        super().__init__(f"not ported to ydb_tpu_torch yet: {what}")
        self.what = what
