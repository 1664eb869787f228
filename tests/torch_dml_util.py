"""The reference engine and the port's side by side, for the write path.

`Pair` runs every statement through `ydb_tpu.query.QueryEngine` and the
port's `QueryEngine(device="cpu")` and holds them equal: a statement's
frame (integers, null masks and row order exact, floats to rtol 1e-9),
`last_rows_affected`, and the error's type name and text when one
raises. Sessions are opened in pairs (`Pair.session()`), so the same
interleaving of transactions runs in both packages.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ydb_tpu.query import QueryEngine as RefEngine
from ydb_tpu_torch.query import QueryEngine as PortEngine

RTOL = 1e-9


def assert_frames_equal(got: pd.DataFrame, want: pd.DataFrame,
                        what: str = "") -> None:
    """Same columns in order and the same rows in order: integers,
    strings and null masks exact, floats to rtol 1e-9."""
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), (what, len(got), len(want))
    for c in want.columns:
        g, w = got[c], want[c]
        gn, wn = g.isna().to_numpy(), w.isna().to_numpy()
        np.testing.assert_array_equal(gn, wn, err_msg=f"{what} {c} nulls")
        gv, wv = g[~gn].to_numpy(), w[~wn].to_numpy()
        if gv.dtype.kind == "f" or wv.dtype.kind == "f":
            np.testing.assert_allclose(gv.astype(np.float64),
                                       wv.astype(np.float64), rtol=RTOL,
                                       err_msg=f"{what} {c}")
        else:
            assert list(gv) == list(wv), (what, c, list(gv), list(wv))


def _run(fn):
    try:
        return fn(), None
    except Exception as e:               # noqa: BLE001 — compared below
        return None, e


def _same_error(sql, re_, pe) -> None:
    """Both engines raised, the same exception type by name and text."""
    assert re_ is not None and pe is not None, (sql, re_, pe)
    assert type(pe).__name__ == type(re_).__name__, (sql, re_, pe)
    assert str(pe) == str(re_), (sql, str(re_), str(pe))


class SessionPair:
    def __init__(self, pair: "Pair"):
        self.pair = pair
        self.ref = pair.ref.session()
        self.port = pair.port.session()

    def run(self, sql: str):
        return self.pair._both(sql, self.ref.execute, self.port.execute)


class Pair:
    def __init__(self, block_rows: int = 1 << 13, fused: bool = True):
        self.ref = RefEngine(block_rows=block_rows)
        self.port = PortEngine(device="cpu", block_rows=block_rows)
        self.set_fused(fused)

    def set_fused(self, fused: bool) -> None:
        self.ref.executor.enable_fused = fused
        self.port.executor.enable_fused = fused

    def session(self) -> SessionPair:
        return SessionPair(self)

    def run(self, sql: str):
        """Run `sql` in both engines' default sessions; returns the
        port's frame (None when both raised the same error)."""
        return self._both(sql, self.ref.execute, self.port.execute)

    def _both(self, sql, ref_exec, port_exec):
        rb, re_ = _run(lambda: ref_exec(sql))
        pb, pe = _run(lambda: port_exec(sql))
        if re_ is not None or pe is not None:
            _same_error(sql, re_, pe)
            return None
        assert self.port.last_rows_affected == \
            self.ref.last_rows_affected, sql
        got, want = pb.to_pandas(), rb.to_pandas()
        assert_frames_equal(got, want, sql)
        return got

    def error(self, sql: str, match: str = "") -> str:
        """Run `sql` in both; both must raise the same error. Returns its
        text."""
        _rb, re_ = _run(lambda: self.ref.execute(sql))
        _pb, pe = _run(lambda: self.port.execute(sql))
        _same_error(sql, re_, pe)
        assert match in str(pe), (match, str(pe))
        return str(pe)

    def plan_pair(self, sql: str):
        """The SELECT's plan in each engine (for reads at a snapshot)."""
        from ydb_tpu.sql import parse as ref_parse
        from ydb_tpu_torch.sql import parse as port_parse
        return (self.ref.planner.plan_select(ref_parse(sql)),
                self.port.planner.plan_select(port_parse(sql)))

    def snapshots(self):
        return self.ref.snapshot(), self.port.snapshot()

    def at(self, plans, snaps, what: str = "") -> pd.DataFrame:
        """Both plans executed at their engine's snapshot, held equal."""
        want = self.ref.executor.execute(plans[0], snaps[0]).to_pandas()
        got = self.port.executor.execute(plans[1], snaps[1]).to_pandas()
        assert_frames_equal(got, want, what)
        return got
