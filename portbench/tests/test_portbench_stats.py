"""Percentile, rate and spread arithmetic on synthetic timelines; a stall
has to move both tails."""
from __future__ import annotations

import importlib.util
import statistics
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import gen, stats

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 99) == 99
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_spread_is_interquartile_over_median():
    v = [10, 11, 12, 13, 14, 15]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / 12.5)


class FakeRun(SimpleNamespace):
    def token_times(self, rec):
        return [None if k is None else self.tick_t[k] for k in rec.ticks]

    def window_recs(self):
        return [r for r in self.recs if r.req.phase == "window"]


def timeline(stall_at=None, stall_s=0.0, seconds=10.0):
    """20 requests due every 0.5 s, each served 10 tokens, one a 20 ms
    tick, the first 30 ms after its due time.  From ``stall_at`` on, the
    engine stalls ``stall_s`` once and then runs three times slower."""
    ticks, recs = [], []
    for i in range(20):
        due = 0.5 * i
        ks = []
        for j in range(10):
            t = due + 0.03 + 0.02 * j
            if stall_at is not None and t >= stall_at:
                t = stall_at + stall_s + 3 * (t - stall_at)
            ks.append(len(ticks))
            ticks.append(t)
        req = gen.Req(i, [1] * 8, 10, due=due, phase="window")
        recs.append(SimpleNamespace(req=req, ticks=ks, submit_t=due,
                                    failed=False))
    return FakeRun(recs=recs, tick_t=ticks, seconds=seconds)


def test_rate_ttft_and_itl_on_a_timeline():
    r = timeline()
    assert reader("output_tok_per_s")(r) == pytest.approx(200 / 10.0)
    assert reader("ttft_p95_ms")(r) == pytest.approx(30.0)
    assert reader("itl_p95_ms")(r) == pytest.approx(20.0)


def test_a_stall_moves_both_tails():
    calm, stalled = timeline(), timeline(stall_at=4.6, stall_s=0.4)
    assert reader("itl_p95_ms")(stalled) == pytest.approx(60.0)
    assert reader("ttft_p95_ms")(stalled) > 10 * reader("ttft_p95_ms")(calm)
    assert reader("output_tok_per_s")(stalled) < reader(
        "output_tok_per_s")(calm)


def test_unserved_request_counts_its_wait_so_far():
    r = timeline(seconds=9.6)
    r.recs[-1].ticks = []                    # due at 9.5 s, never served
    ttfts = sorted([30.0] * 19 + [100.0])
    assert reader("ttft_p95_ms")(r) == pytest.approx(
        stats.percentile(ttfts, 95), abs=1e-6)


def test_check_sample_spreads_over_slots():
    from portbench import check

    def rec(n, slot):
        return SimpleNamespace(seq=SimpleNamespace(generated=[0] * n,
                                                   prompt=[0]), slot=slot)
    # 40 records on 4 slots, the longest on slot 0
    recs = [rec(10 + i, i % 4) for i in range(40)]
    for seed in range(5):
        got = check.sample(recs, 4, seed)
        assert got[0] is recs[-1]
        assert sorted(r.slot for r in got) == [0, 1, 2, 3]
        more = check.sample(recs, 9, seed)
        assert len({id(r) for r in more}) == 9
        assert more == check.sample(recs, 9, seed)
