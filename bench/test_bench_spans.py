"""The reduction of the program's ranges (``spans.py``) and the metrics
that read it, on synthetic event lists shaped as the profiler's Chrome
trace: launches attributed across threads, the backward by its ``.bwd``
ranges, the recompute apart from it, idle time intersected with the
engine's phases; each reader returns None without a trace or without its
ranges.  A tiny serving run on the CPU splits its idle window whole."""
from __future__ import annotations

import types

import pytest

from bench import harness, spans, trace
from bench.conftest import tiny_cell
from bench.test_bench_imports import imported

MAIN, AUTOGRAD = 1, 2
TRAIN_READERS = ("backward_share.train", "optimizer_share.train",
                 "recompute_share.train", "swa_attn_share.train")
SERVE_READERS = ("dispatch_idle.serve", "engine_host_idle.serve")


class Events:
    """A Chrome trace's complete events, in microseconds."""

    def __init__(self):
        self.events, self.corr = [], 0

    def range(self, name, a, b, tid=MAIN):
        self.events.append({"ph": "X", "cat": "user_annotation",
                            "name": name, "ts": a, "dur": b - a,
                            "tid": tid})

    def kernel(self, launch, a, b, tid=MAIN, name="k"):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernel", "ts": launch,
                            "dur": 1, "tid": tid,
                            "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": "kernel", "name": name,
                            "ts": a, "dur": b - a,
                            "args": {"correlation": self.corr}})

    def trace(self):
        return trace.Trace(self.events)


def train_events() -> trace.Trace:
    """One step: a forward, a backward whose autograd thread runs the
    head's and the SWA layer's backward and, inside the MLP's, the
    recompute; an optimizer.  Busy 100 µs of a 110 µs window."""
    e = Events()
    e.range("bench.window", 0, 110)
    e.range("train.step", 0, 110)
    e.range("train.forward", 0, 30)
    e.range("model.attn.swa", 1, 10)
    e.kernel(2, 5, 15)                                    # swa fwd 10
    e.range("model.mlp", 11, 20)
    e.kernel(12, 15, 35)                                  # mlp fwd 20
    e.range("train.backward", 30, 90)
    e.range("model.head.bwd", 31, 40, AUTOGRAD)
    e.kernel(32, 35, 45, AUTOGRAD)                        # head bwd 10
    e.range("model.mlp.bwd", 41, 70, AUTOGRAD)
    e.range("model.attn.swa", 42, 50, AUTOGRAD)           # recompute
    e.kernel(43, 45, 55, AUTOGRAD)                        # 10
    e.kernel(60, 55, 65, AUTOGRAD)                        # mlp bwd 10
    e.range("model.attn.swa.bwd", 71, 85, AUTOGRAD)
    e.kernel(72, 65, 85, AUTOGRAD)                        # swa bwd 20
    e.kernel(86, 85, 90, AUTOGRAD)                        # no layer 5
    e.range("train.optimizer", 90, 110)
    e.kernel(91, 90, 105)                                 # optimizer 15
    return e.trace()


def serve_events() -> trace.Trace:
    """Two engine steps in a 100 µs window; busy 40 µs."""
    e = Events()
    e.range("bench.window", 0, 100)
    e.range("engine.step", 5, 50)
    e.range("engine.plan", 5, 10)
    e.range("engine.prefill.dispatch", 10, 20)
    e.range("model.attn.swa", 12, 18)
    e.kernel(12, 15, 30)                       # busy 15-30
    e.range("engine.prefill.sync", 20, 30)
    e.range("engine.decode.dispatch", 30, 40)
    e.kernel(35, 38, 48)                       # busy 38-48
    e.range("engine.retire", 45, 50)
    e.range("engine.step", 60, 90)
    e.range("engine.decode.dispatch", 60, 80)
    e.kernel(62, 75, 90)                       # busy 75-90
    return e.trace()


def read(name: str, t, stats=None):
    ctx = types.SimpleNamespace(rec={"trace": t, "stats": stats or {}})
    return harness.reader(name).read(ctx)


def test_launches_are_attributed_across_threads():
    t = train_events()
    assert t.busy_s == pytest.approx(100e-6)
    # train.backward is open on the main thread; autograd launches
    assert spans.launched_under(t, "train.backward") == pytest.approx(
        55e-6)
    assert spans.launched_under(t, "train.optimizer") == pytest.approx(
        15e-6)
    assert spans.launched_under(t, "train.nothing") is None
    assert read("backward_share.train", t) == pytest.approx(55.0)
    assert read("optimizer_share.train", t) == pytest.approx(15.0)


def test_innermost_range_on_the_launching_thread():
    t = train_events()
    got = {(a, b): r and r[2] for a, b, _, r in spans.innermost(t,
                                                                "model.")}
    assert got[(5, 15)] == "model.attn.swa"
    assert got[(45, 55)] == "model.attn.swa"          # inside mlp.bwd
    assert got[(55, 65)] == "model.mlp.bwd"
    assert got[(65, 85)] == "model.attn.swa.bwd"
    assert got[(85, 90)] is None
    assert got[(90, 105)] is None


def test_backward_recompute_and_swa_are_split():
    split = spans.train_split(train_events())
    assert split["model.head.bwd"] == pytest.approx(10e-6)
    assert split["model.attn.swa.bwd"] == pytest.approx(20e-6)
    assert split["recompute"] == pytest.approx(10e-6)
    assert split["swa_attn"] == pytest.approx(40e-6)   # fwd, re, bwd
    assert split["model_in_backward"] == pytest.approx(50e-6)
    t = train_events()
    assert read("recompute_share.train", t) == pytest.approx(10.0)
    assert read("swa_attn_share.train", t) == pytest.approx(40.0)


def test_idle_time_is_intersected_with_the_engine_phases():
    t = serve_events()
    split = spans.serve_idle_split(t)
    # idle: 0-15, 30-38, 48-75, 90-100 = 60 µs
    assert split["idle"] == pytest.approx(60e-6)
    # dispatch ∩ idle: 10-15 (prefill), 30-38 (decode), 60-75 (decode)
    assert split["dispatch"] == pytest.approx(28e-6)
    # rest of engine.step ∩ idle: 5-10 (plan), 48-50 (retire)
    assert split["engine"] == pytest.approx(7e-6)
    assert split["outside"] == pytest.approx(25e-6)
    assert read("dispatch_idle.serve", t) == pytest.approx(28.0)
    assert read("engine_host_idle.serve", t) == pytest.approx(7.0)
    assert read("dispatch_idle.serve", t) \
        + read("engine_host_idle.serve", t) + 25.0 == pytest.approx(
            100.0 * (1 - t.busy_s / t.window_s))


def test_host_segments_follow_the_innermost_range():
    segs = spans.host_segments([(0, 10, "engine.step"),
                                (2, 4, "engine.plan"),
                                (4, 8, "engine.decode.dispatch"),
                                (5, 6, "kernel.moba_decode")])
    assert segs == [(0, 2, "engine.step"), (2, 4, "engine.plan"),
                    (4, 5, "engine.decode.dispatch"),
                    (5, 6, "kernel.moba_decode"),
                    (6, 8, "engine.decode.dispatch"),
                    (8, 10, "engine.step")]


@pytest.mark.parametrize("name", TRAIN_READERS + SERVE_READERS)
def test_a_reader_is_none_without_a_trace_or_its_ranges(name):
    assert read(name, None) is None
    e = Events()
    e.range("bench.window", 0, 50)
    e.range("bench.flash_moba", 0, 40)
    e.kernel(1, 5, 30)
    assert read(name, e.trace()) is None


def test_queue_wait_reads_the_schedulers_counters():
    assert read("queue_wait_ms.serve", None, {}) is None
    assert read("queue_wait_ms.serve", None, {"admitted": 0,
                                              "queue_wait_s": 0.0}) is None
    assert read("queue_wait_ms.serve", None, {
        "admitted": 4, "queue_wait_s": 0.5}) == pytest.approx(125.0)


def test_spans_imports_nothing_of_the_program():
    names = set(imported(harness.ROOT / "bench" / "spans.py"))
    assert not names & {"repro_torch", "repro", "jax", "torch"}


def test_a_tiny_serving_run_splits_its_idle_window(steady_clock):
    spec, files = tiny_cell("moba340m-serve-c32")
    out = harness.run_cell("moba340m-serve-c32", 2_300_000_019, 0.2, True,
                           device="cpu", spec=spec, files=files)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["queue_wait_ms.serve"] >= 0.0
    assert 0.0 < m["dispatch_idle.serve"] <= m["device_idle.serve"]
    assert m["engine_host_idle.serve"] > 0.0
