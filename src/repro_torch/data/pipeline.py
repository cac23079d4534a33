"""Deterministic, shardable, checkpointable LM data pipeline.

Synthetic corpus with learnable structure (order-2 Markov chain over the
vocab + periodic copy patterns) so small models show real loss curves and
MoBA's retrieval machinery has signal to find.  The iterator is:

  * host-shardable: host i of H draws disjoint batch slices,
  * deterministic: batch at step t is a pure function of (seed, t, host),
  * checkpointable: state is just the step counter.

This is the pattern a real cluster pipeline needs for fault-tolerant
restarts (resume at step t reproduces the exact stream).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    markov_order_states: int = 64   # # of latent states in the chain
    copy_period: int = 0            # 0 = off; else plant copy patterns


class SyntheticLM:
    """Order-1 Markov over latent states, each emitting a vocab shard."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        rng = np.random.default_rng(cfg.seed)
        s = cfg.markov_order_states
        # sparse-ish transition matrix → low entropy → learnable
        trans = rng.dirichlet(np.full(s, 0.1), size=s).astype(np.float32)
        self._trans_cdf = np.cumsum(trans, axis=1)
        self._emit_base = rng.integers(0, max(cfg.vocab_size - s, 1),
                                       size=s)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host): (local_batch, seq+1)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.host_id)
        b, t = self.local_batch, cfg.seq_len + 1
        s = cfg.markov_order_states
        states = np.zeros((b, t), np.int64)
        states[:, 0] = rng.integers(0, s, size=b)
        u = rng.random((b, t))
        for i in range(1, t):
            cdf = self._trans_cdf[states[:, i - 1]]
            states[:, i] = (u[:, i:i + 1] < cdf).argmax(axis=1)
        offs = rng.integers(0, max(s, 2), size=(b, t))
        tokens = (self._emit_base[states] + offs) % cfg.vocab_size
        if cfg.copy_period:
            # plant a needle early and a cue+copy near the end: long-range
            p = cfg.copy_period
            span = min(8, t // 8)
            src = rng.integers(1, max(t // 4, 2), size=b)
            for bi in range(b):
                seg = tokens[bi, src[bi]:src[bi] + span]
                tokens[bi, -span:] = seg
        return {"tokens": tokens.astype(np.int32)}

    def iterator(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1

    def state(self, step: int) -> dict:
        return {"step": step, "seed": self.cfg.seed,
                "host_id": self.host_id}
