"""The general request generator that every serving traffic file
parameterises.

A traffic file of ``kind`` ``serve`` gives:

- ``prompt`` and ``output``: token-length distributions, each ``{"dist":
  "log_uniform" | "uniform", "min": a, "max": b}``;
- ``pool``: how many (prompt, output) sizes the requests cycle through,
  in a fixed order: the distributions' stratified quantiles, paired and
  ordered by fixed permutations.  The seed draws the token ids and not
  the sizes, so every seed serves the same work in the same order (with
  no end-of-sequence token, a request's output is its size);
- ``arrivals``: ``{"kind": "closed", "clients": n}`` (each client sends
  its next request when the previous one ends; the only kind);
- ``engine``: the engine's settings (``EngineConfig`` fields);
- ``check_tokens``: served tokens the correctness sample reaches.

Token ids are uniform over the vocabulary, drawn from the seed.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def quantiles(dist: dict, n: int) -> List[int]:
    """``n`` stratified quantiles (midpoints) of a length distribution."""
    a, b = dist["min"], dist["max"]
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "log_uniform":
        x = np.exp(math.log(a) + (math.log(b) - math.log(a)) * u)
    elif dist["dist"] == "uniform":
        x = a + (b - a) * u
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(round(v)) for v in x]


def sizes(traffic: dict) -> List[Tuple[int, int]]:
    """The (prompt, output) sizes the requests cycle through, in order."""
    n = traffic["pool"]
    prompts = quantiles(traffic["prompt"], n)
    outs = quantiles(traffic["output"], n)
    rng = np.random.default_rng(0)
    a, b = rng.permutation(n), rng.permutation(n)
    return [(prompts[i], outs[j]) for i, j in zip(a, b)]


def max_len(traffic: dict) -> int:
    """The longest sequence a request can reach (prompt + output)."""
    return traffic["prompt"]["max"] + traffic["output"]["max"]


class RequestStream:
    """The run's requests in sending order, drawn from ``seed``."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        if traffic["arrivals"]["kind"] != "closed":
            raise ValueError(f"unknown arrivals "
                             f"{traffic['arrivals']['kind']!r}")
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.sizes = sizes(traffic)
        self.count = 0

    def next(self) -> Tuple[np.ndarray, int]:
        """(prompt token ids, max new tokens) of the next request."""
        plen, out = self.sizes[self.count % len(self.sizes)]
        ids = self.rng.integers(0, self.vocab, plen, dtype=np.int32)
        self.count += 1
        return ids, out
