"""Needle-in-a-haystack synthetic task (RULER S-NIAH analogue).

A (key, value) pair is planted at a random position in a filler context;
the prompt ends with the key and the model (or, for router-only eval, the
MoBA router) must retrieve the value / the needle's block.  Numpy
only; the same generator as the reference's, so a seed gives the same
batches in both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_niah_batch(rng: np.random.Generator, batch: int, seq_len: int,
                    vocab_size: int, needle_len: int = 4
                    ) -> Dict[str, np.ndarray]:
    """Returns tokens (B, S), needle_pos (B,), value tokens (B, needle_len).

    Layout: [filler ... KEY VALUE ... filler ... KEY] → next tokens should
    be VALUE.  KEY is a reserved sentinel pair unlikely in filler.
    """
    key_tok = vocab_size - 1
    filler = rng.integers(0, vocab_size - 2,
                          size=(batch, seq_len)).astype(np.int32)
    pos = rng.integers(1, seq_len - 3 * needle_len - 2, size=batch)
    value = rng.integers(0, vocab_size - 2,
                         size=(batch, needle_len)).astype(np.int32)
    toks = filler.copy()
    for b in range(batch):
        toks[b, pos[b]] = key_tok
        toks[b, pos[b] + 1:pos[b] + 1 + needle_len] = value[b]
        toks[b, -1] = key_tok   # query cue at the end
    return {"tokens": toks, "needle_pos": pos.astype(np.int32),
            "value": value}


def router_retrieval_accuracy(sel_blocks: np.ndarray, needle_pos: np.ndarray,
                              block_size: int) -> float:
    """Fraction of final-position queries whose selected top-k blocks
    include the needle's block. sel_blocks: (B, k) for the last query."""
    target = needle_pos // block_size
    hit = (sel_blocks == target[:, None]).any(axis=1)
    return float(hit.mean())
