"""Faults planted under the timed path, to show that ``correct`` catches
them (``test_bench_faults.py``, ``calibrate.py``).  None plants nothing.

- ``unchanged``: a step that returns its state unchanged (training: the
  parameters and moments stay as they were; serving: a decode step
  appends no key or value to the pool);
- ``half``: half of the batch left out, the loss the mean over the rest
  (the first half of the rows is stepped on; with one row, the second
  half of its positions is masked out of the loss);
- ``token``: a served token altered where the decode step produces it.
"""
from __future__ import annotations

import contextlib
import copy

import torch

TRAIN = ("unchanged", "half")
SERVE = ("unchanged", "token")


def train_step(step, fault, rows: int, seq: int):
    """The program's step, or the step with ``fault`` planted."""
    if fault is None:
        return step
    if fault == "unchanged":
        def unchanged(params, opt, batch):
            _, _, out = step(copy.deepcopy(params), copy.deepcopy(opt),
                             batch)
            return params, opt, out
        return unchanged
    if fault == "half":
        def half(params, opt, batch):
            tok = batch["tokens"]
            if rows >= 2:
                return step(params, opt, {"tokens": tok[:rows // 2]})
            mask = torch.ones((rows, seq), device=tok.device)
            mask[:, seq // 2:] = 0
            return step(params, opt, {"tokens": tok, "mask": mask})
        return half
    raise ValueError(f"no training fault {fault!r}; have {TRAIN}")


@contextlib.contextmanager
def serving(engine, fault, vocab: int, every: int = 7):
    """``engine`` with ``fault`` planted for the duration."""
    if fault is None:
        yield
        return
    if fault == "unchanged":
        from repro_torch.serving import paged_cache

        keep = paged_cache.paged_append_decode
        paged_cache.paged_append_decode = lambda *a, **k: None
        try:
            yield
        finally:
            paged_cache.paged_append_decode = keep
        return
    if fault == "token":
        decode, calls = engine._decode, [0]

        def altered(params, token, caches, block_table, kv_len, active):
            tok, caches = decode(params, token, caches, block_table, kv_len,
                                 active)
            calls[0] += 1
            if calls[0] % every == 0:
                tok = torch.where(active, (tok + 1) % vocab, tok)
            return tok, caches
        engine._decode = altered
        try:
            yield
        finally:
            engine._decode = decode
        return
    raise ValueError(f"no serving fault {fault!r}; have {SERVE}")
