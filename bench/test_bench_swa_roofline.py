"""``swa_roofline.train``: the SWA layers' attention work counted by hand
at the cells' shapes, and the reader on synthetic traces (None without a
trace or without the program's ``kernel.swa`` ranges, as from a program
that has none)."""
from __future__ import annotations

import json
import types

import pytest

from bench import arith, harness
from bench.conftest import ROOT
from bench.test_bench_spans import Events


def _config(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name,rows,heads", [("moba-340m", 4, 16),
                                             ("moba-1b", 1, 32)])
def test_swa_work_by_hand(name, rows, heads):
    """12 SWA layers of d 64 heads, window 256 over 8,192 tokens:
    2,064,512 keys a head (256 a query, fewer in the first 255); forward
    q, k, v, o and backward eight such tensors at 2 bytes, both bound by
    bytes at these shapes."""
    least = harness.reader("swa_roofline.train").swa_train_least_s
    keys = 256 * 8192 - 256 * 255 // 2
    assert keys == 2_064_512
    tensor = rows * heads * 8192 * 64 * 2
    fwd = max(rows * heads * 4 * 64 * keys / arith.PEAK_BF16_FLOPS,
              4 * tensor / arith.PEAK_HBM_BYTES_PER_S)
    bwd = max(rows * heads * 10 * 64 * keys / arith.PEAK_BF16_FLOPS,
              8 * tensor / arith.PEAK_HBM_BYTES_PER_S)
    assert bwd == 8 * tensor / arith.PEAK_HBM_BYTES_PER_S
    assert least(_config(name), rows, 8192) == pytest.approx(
        12 * (fwd + bwd), rel=1e-12)


def _read(t, rows=1):
    ctx = types.SimpleNamespace(
        rec={"trace": t, "profiled_steps": 1}, config=_config("moba-1b"),
        traffic={"rows": rows, "seq_len": 8192})
    return harness.reader("swa_roofline.train").read(ctx)


def test_swa_roofline_reads_the_kernel_ranges():
    """Device time under ``kernel.swa`` on the main thread and under
    ``kernel.swa_bwd`` on autograd's, nothing else."""
    least = harness.reader("swa_roofline.train").swa_train_least_s(
        _config("moba-1b"), 1, 8192)
    e = Events()
    e.range("bench.window", 0, 10_000)
    e.range("kernel.swa", 0, 100)
    e.kernel(1, 10, 2_010)                          # 2,000 µs forward
    e.kernel(200, 2_100, 9_000)                     # outside the ranges
    e.range("kernel.swa_bwd", 300, 400, tid=2)
    e.kernel(310, 9_000, 9_500, tid=2)              # 500 µs backward
    assert _read(e.trace()) == pytest.approx(100 * least / 2.5e-3)


def test_swa_roofline_is_none_without_its_ranges():
    assert _read(None) is None
    e = Events()
    e.range("bench.window", 0, 50)
    e.range("model.attn.swa", 0, 40)
    e.kernel(1, 5, 30)
    assert _read(e.trace()) is None
