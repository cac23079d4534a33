"""The request generator: the same sizes in the same order for every
seed, token ids from the seed, closed loops only."""
from __future__ import annotations

import pytest

from bench import traffic
from bench.conftest import load


def test_every_seed_serves_the_same_sizes_in_the_same_order():
    tr = load("bench/traffic/serve-closed-c32.json")
    a, b = (traffic.RequestStream(tr, 32000, s) for s in (1, 2 ** 40 + 3))
    ra = [a.next() for _ in range(2 * tr["pool"])]
    rb = [b.next() for _ in range(2 * tr["pool"])]
    assert [(len(p), o) for p, o in ra] == [(len(p), o) for p, o in rb]
    assert any((p != q).any() for (p, _), (q, _) in zip(ra, rb))
    lens = sorted(len(p) for p, _ in ra[:tr["pool"]])
    assert lens[0] >= tr["prompt"]["min"] and lens[-1] <= tr["prompt"]["max"]
    outs = [o for _, o in ra]
    assert min(outs) >= 16 and max(outs) <= 64 and len(set(outs)) > 20


def test_quantiles_are_stratified():
    assert traffic.quantiles({"dist": "uniform", "min": 0, "max": 10},
                             5) == [1, 3, 5, 7, 9]
    q = traffic.quantiles({"dist": "log_uniform", "min": 1, "max": 100}, 2)
    assert q == [round(10 ** 0.5), round(10 ** 1.5)]


def test_the_longest_sequence_is_the_longest_prompt_and_output():
    tr = load("bench/traffic/serve-closed-c32.json")
    assert traffic.max_len(tr) == 4096 + 64
    s = traffic.RequestStream(tr, 1000, 9)
    reqs = [s.next() for _ in range(tr["pool"])]
    assert max(len(p) + o for p, o in reqs) <= traffic.max_len(tr)


def test_only_closed_loops_are_generated():
    tr = dict(load("bench/traffic/serve-closed-c32.json"),
              arrivals={"kind": "poisson", "rate": 4.0})
    with pytest.raises(ValueError, match="poisson"):
        traffic.RequestStream(tr, 1000, 9)
