"""The order in which a DQ channel's frames drain on the host plane
(`ydb_tpu_torch/dq/runner.py OrderedExchangeBuffer`, the in-process
worker's exchange buffer).

Producer tasks run on a thread pool and each ships its frames from a
pool of its own, so frames land in an order that changes from run to
run. Drained in that order (as `cluster/exchange.py ExchangeBuffer`,
the reference's copy, drains), a consumer stage that sums floats over
the rows gave answers that differed in their last bits between runs,
and from the ICI plane's (which lands each producer's rows in worker
order). The worker's buffer drains a channel by producer and sequence,
whatever the landing order: these tests land frames in shuffled and
reversed orders and hold the drain, and a float-summing shuffle query,
to one answer.
"""

import numpy as np
import pandas as pd
import pytest

from tests.torch_dq_util import cluster, frames_equal, port_engines, tu_tables
from ydb_tpu_torch.dq.runner import OrderedExchangeBuffer
from tests import torch_threads  # noqa: F401,E402

SOURCES = ["g.s0.w0", "g.s0.w1", "g.s0.w2", "g.s0.w10"]


def _frames(n_seq: int = 3) -> list:
    """(src, seq, frame): a frame per producer and sequence number, its
    one column naming both."""
    return [(src, seq, pd.DataFrame({"src": [src] * 2, "seq": [seq] * 2}))
            for src in SOURCES for seq in range(n_seq)]


@pytest.mark.parametrize("seed", range(6))
def test_drain_follows_producer_then_seq(seed):
    frames = _frames()
    order = np.random.default_rng(seed).permutation(len(frames))
    buf = OrderedExchangeBuffer()
    for i in order:
        src, seq, df = frames[i]
        assert buf.put("ch", df, 16, src=src, seq=seq)
    got = buf.take("ch")
    # producers by the numbers in their names (w2 before w10), then seq
    want = pd.concat([df for (_s, _q, df) in frames], ignore_index=True)
    pd.testing.assert_frame_equal(got, want)
    assert buf.bytes == 0


def test_unsequenced_frames_keep_landing_order():
    buf = OrderedExchangeBuffer()
    for v in (3, 1, 2):
        buf.put("ch", pd.DataFrame({"v": [v]}), 8, src="p")
    buf.put("ch", pd.DataFrame({"v": [0]}), 8, src="p", seq=0)
    assert list(buf.take("ch").v) == [3, 1, 2, 0]


def test_drop_and_take2_bytes_with_ordered_frames():
    buf = OrderedExchangeBuffer()
    for (src, seq, df) in _frames(2):
        buf.put("a", df, 10, src=src, seq=seq)
        buf.put("b", df, 5, src=src, seq=seq)
    buf.drop("b")
    assert buf.bytes == 10 * 2 * len(SOURCES)
    _df, nbytes = buf.take2("a")
    assert nbytes == 10 * 2 * len(SOURCES) and buf.bytes == 0


# -- a shuffle query's float sums, whatever the landing order ---------------

ROWS = 3000
NW = 4
KEYS = {"t": ["id"], "u": ["uid"]}
SUM_SQL = ("select k, count(*) as n, sum(v) as s, sum(v * x) as sx "
           "from t, u where k = uid group by k order by k")


@pytest.fixture(scope="module")
def port_cluster():
    tables = tu_tables(ROWS)
    # values whose float sum depends on the order of its terms (the
    # harness's own v is dyadic, exact in any order)
    rng = np.random.default_rng(7)
    tables["t"][2]["v"] = rng.random(ROWS) * 1e3 + rng.random(ROWS) * 1e-7
    return cluster("port", port_engines(tables, NW), KEYS, name="fo")


def _query(monkeypatch, c, plane):
    monkeypatch.setenv("YDB_TPU_DQ_PLANE", plane)
    monkeypatch.setenv("YDB_TPU_DQ_QUANT", "0")
    return c.query(SUM_SQL)


@pytest.mark.parametrize("landing", ["reversed", "shuffled"])
def test_host_plane_answer_ignores_landing_order(monkeypatch, port_cluster,
                                                 landing):
    want = _query(monkeypatch, port_cluster, "host")
    assert len(want) == 7 and want.n.sum() == ROWS
    take2 = OrderedExchangeBuffer.take2
    rng = np.random.default_rng(11)
    landed = []

    def take2_out_of_order(self, channel):
        # as if the frames had landed in another order: the frames and
        # their drain keys permuted alike
        with self._order_mu, self._mu:
            frames = self._frames.get(channel, [])
            keys = self._order.get(channel, [])
            assert len(keys) == len(frames)
            landed.append(len(frames))
            perm = np.arange(len(frames))[::-1] if landing == "reversed" \
                else rng.permutation(len(frames))
            frames[:] = [frames[i] for i in perm]
            keys[:] = [keys[i] for i in perm]
        return take2(self, channel)

    monkeypatch.setattr(OrderedExchangeBuffer, "take2",
                        take2_out_of_order)
    got = _query(monkeypatch, port_cluster, "host")
    assert max(landed) >= NW          # frames from every producer
    frames_equal(got, want)
    # and the ICI plane, which lands the producers' rows in worker order
    frames_equal(_query(monkeypatch, port_cluster, "auto"), want)
