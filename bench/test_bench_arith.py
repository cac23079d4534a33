"""The frozen metric arithmetic: model FLOPs equal the port's
``launch/steps.py::model_flops``, and the MoBA work counts equal values
worked by hand at small shapes."""
from __future__ import annotations

import pytest

from bench import arith
from bench.conftest import load, tiny_config
from bench.runners import program


@pytest.mark.parametrize("name", ["moba-340m", "moba-1b"])
@pytest.mark.parametrize("rows,seq", [(1, 8192), (4, 8192), (2, 1000)])
def test_train_flops_equal_the_ports(name, rows, seq):
    from repro_torch.launch import steps

    cfg = load(f"bench/configs/{name}.json")
    want = steps.model_flops(program.model_config(cfg),
                             (seq, rows, "train"))
    assert arith.train_flops(cfg, rows, seq) == want
    assert arith.forward_flops(cfg, rows * seq) == steps.model_flops(
        program.model_config(cfg), (seq, rows, "prefill"))


def test_moba_1b_step_flops():
    cfg = load("bench/configs/moba-1b.json")
    assert arith.train_flops(cfg, 1, 8192) == 82_390_995_173_376


def test_keys_attended_by_hand():
    # block 4, seq 8: queries 0-3 see their own block up to themselves
    # (1+2+3+4); queries 4-7 add the whole first block when top_k >= 2
    assert arith._keys_attended(8, 4, 1) == (10 + 10, 4 * 1 + 4 * 2)
    assert arith._keys_attended(8, 4, 2) == (10 + 26, 12)


def test_moba_train_work_by_hand():
    cfg = tiny_config()          # 4 layers, 2 of them MoBA, 4 heads of 16
    cfg["moba"] = dict(cfg["moba"], block_size=4, top_k=2)
    w = arith.moba_train_work(cfg, rows=3, seq=8, el_bytes=2)
    keys, blocks = 36, 12
    fwd = 3 * 4 * (4 * 16 * keys + 2 * 16 * blocks)
    bwd = 3 * 4 * 10 * 16 * keys
    q = kv = 3 * 4 * 8 * 16
    assert w["fwd"] == (2 * fwd, 2 * (2 * q + 2 * kv) * 2)
    assert w["bwd"] == (2 * bwd, 2 * (4 * q + 4 * kv) * 2)
    want = 2 * (max(fwd / arith.PEAK_BF16_FLOPS,
                    (2 * q + 2 * kv) * 2 / arith.PEAK_HBM_BYTES_PER_S)
                + max(bwd / arith.PEAK_BF16_FLOPS,
                      (4 * q + 4 * kv) * 2 / arith.PEAK_HBM_BYTES_PER_S))
    assert w["least_s"] == pytest.approx(want, rel=1e-12)


def test_moba_decode_work_by_hand():
    cfg = load("bench/configs/moba-340m.json")   # 16 heads of 64, top_k 8
    h, d = 16, 64
    # 130 tokens: 2 pages, both attended (128 + 2 keys); 2,000 tokens:
    # 16 pages, 7 full ones and the own page's 80 keys; 0: an idle slot
    flops, nbytes, least = arith.moba_decode_work(cfg, [130, 2000, 0], 128)
    keys, pages = 130 + 976, 2 + 16
    assert flops == h * (2 * d * pages + 4 * d * keys)
    assert nbytes == (2 * (2 * h * d * 2) + pages * h * d * 4 + pages * 4
                      + 2 * keys * h * d * 2)
    assert least == max(flops / arith.PEAK_BF16_FLOPS,
                        nbytes / arith.PEAK_HBM_BYTES_PER_S)
