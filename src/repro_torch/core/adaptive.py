"""SNR-guided adaptive routing: per-(layer, head) top_k from measured SNR.

The paper's statistical model (``core/snr.py``) says block retrieval is
governed by SNR = Δμ_eff·sqrt(d/2B) and that reliable top-k retrieval
among n blocks needs SNR > Φ⁻¹(1 − k/n) (App. A.4).  This module turns
the model into a serve-time policy:

  1. **Calibration** (:func:`calibrate_profile`): run a calibration batch
     through the model with a routing-score capture hook (the
     ``core.moba`` sink), estimate each (layer, head)'s retrieval margin
     — the gap between the best non-own block score and the noise-block
     distribution, in noise-σ units — and average it into a measured SNR
     per (layer slot, group, kv head, query head).
  2. **Inversion** (:func:`choose_top_k`): pick the smallest ``top_k``
     whose App.-A.4 bound the measured SNR clears with a Φ⁻¹(1 − p_fail)
     safety margin; heads whose routing signal is weak keep the static
     ``k_max``.  Adaptive routing only ever *reduces* top_k, so pool
     shapes and kernel grids stay static.
  3. **Artifact** (:class:`RoutingProfile`): the per-head table is
     serialized to JSON (the reference's schema, ``version: 1``, so a
     profile written by either package loads in the other) and replayed
     by any engine (``route_policy="profile:<path>"``).

At serve time the profile becomes a ``route_map`` of per-layer-slot
(n_groups, H) int32 tensors threaded through the model; every paged
MoBA path (one-shot and chunked prefill, decode) truncates its
score-sorted static top-k to the head's budget (``head_top_k``,
``core.moba._truncate_head_topk``), and on the card the decode route
kernel applies the budgets itself (``kernels/csrc/moba_decode.cu``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.snr import _norm_ppf, required_snr

# fewer causal noise blocks than this and the noise-σ estimate is
# meaningless — the head keeps the static top_k
MIN_NOISE_BLOCKS = 3


def parse_route_policy(policy: str) -> Tuple[str, Optional[object]]:
    """``"static" | "snr:pfail=P" | "profile:PATH"`` → (mode, arg).

    Raises ValueError on anything else (the engine wraps it into its
    admission-time :class:`UnsupportedFeatureError`).
    """
    policy = (policy or "static").strip()
    if policy == "static":
        return "static", None
    mode, _, arg = policy.partition(":")
    if mode == "snr":
        if not arg.startswith("pfail="):
            raise ValueError(
                f"route policy {policy!r}: snr mode takes pfail=P "
                f"(e.g. 'snr:pfail=0.01')")
        try:
            pfail = float(arg[len("pfail="):])
        except ValueError:
            raise ValueError(
                f"route policy {policy!r}: pfail must be a float") from None
        if not 0.0 < pfail < 0.5:
            raise ValueError(
                f"route policy {policy!r}: pfail must be in (0, 0.5)")
        return "snr", pfail
    if mode == "profile":
        if not arg:
            raise ValueError(
                f"route policy {policy!r}: profile mode takes a path "
                f"(e.g. 'profile:routing_profile.json')")
        return "profile", arg
    raise ValueError(
        f"unknown route policy {policy!r}; expected 'static', "
        f"'snr:pfail=P' or 'profile:PATH'")


# -------------------------------------------------------------- score sink
@contextlib.contextmanager
def capture_routing_scores():
    """Context manager: while active, every ``core.moba.moba_selection``
    call appends ``(scores (B,Hkv,G,Nq,nb) fp32, q_positions (Nq,))`` to
    the yielded list, in layer order: group-major, pattern slots inside
    each group (the model's group loop)."""
    from repro_torch.core import moba as M

    captured: List[tuple] = []
    prev = M._score_sink
    M._score_sink = captured.append
    try:
        yield captured
    finally:
        M._score_sink = prev


def _as_numpy(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def estimate_head_snr(scores, q_positions, block_size: int) -> np.ndarray:
    """Measured per-head routing SNR from one layer's routing scores.

    scores: (B, Hkv, G, Nq, nb) centroid scores; q_positions: (Nq,)
    (tensors or arrays).  For every query in the *last* own-block (the
    most context any query sees), the best non-own causal block plays
    the signal and the remaining causal blocks the noise: the margin
    (top1 − μ_noise)/σ_noise is the quantity App. A.4's Φ⁻¹(1 − k/n)
    bound is stated in.  Averaged over batch and those queries →
    (Hkv, G) float64.  Heads with fewer than ``MIN_NOISE_BLOCKS`` noise
    blocks report 0 (never adapted).
    """
    s = _as_numpy(scores, np.float64)
    pos = _as_numpy(q_positions, np.int64).reshape(-1)
    b, hkv, g, nq, nb = s.shape
    own_last = int(pos[-1]) // block_size
    n_noise = own_last            # causal non-own blocks: 0 .. own_last-1
    if n_noise < MIN_NOISE_BLOCKS + 1:
        return np.zeros((hkv, g))
    ts = [t for t in range(nq) if int(pos[t]) // block_size == own_last]
    rows = s[:, :, :, ts, :own_last]            # (B,Hkv,G,T,n_noise)
    top1 = rows.max(axis=-1)
    total = rows.sum(axis=-1)
    sq = (rows ** 2).sum(axis=-1)
    mean_rest = (total - top1) / (n_noise - 1)
    var_rest = np.maximum(
        (sq - top1 ** 2) / (n_noise - 1) - mean_rest ** 2, 1e-12)
    snr = (top1 - mean_rest) / np.sqrt(var_rest)
    return snr.mean(axis=(0, -1))               # (Hkv, G)


def choose_top_k(snr_hat, num_blocks: int, k_max: int,
                 pfail: float) -> np.ndarray:
    """Smallest per-head top_k whose required SNR (App. A.4) the measured
    SNR clears with a Φ⁻¹(1 − pfail) margin; ``k_max`` where none does.

    snr_hat: any-shape array of measured SNRs → same-shape int32 in
    [1, k_max].  Never above the static budget, so shapes stay static.
    """
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    z = _norm_ppf(1.0 - pfail)
    snr = np.asarray(snr_hat, np.float64)
    k = np.full(snr.shape, k_max, np.int32)
    for cand in range(k_max - 1, 0, -1):
        # k >= n retrieves everything: the bound is vacuous (need -inf)
        need = (required_snr(num_blocks, cand) + z
                if cand < num_blocks else -np.inf)
        k = np.where(snr >= need, np.int32(cand), k)
    # selection pins the query's own page at rank 0 (POS_INF), so a
    # budget of k leaves k-1 score-retrieval slots; reserve one for it.
    return np.clip(k + 1, 1, k_max).astype(np.int32)


# ----------------------------------------------------------------- profile
@dataclasses.dataclass
class RoutingProfile:
    """Serialized outcome of a calibration pass.

    ``top_k`` maps each layer-pattern slot (``"slot_i"``, moba slots
    only) to an (n_groups, H) int32 array of per-head budgets, flattened
    query-head order h = hkv·G + g (the ``_group_queries`` reshape).
    ``snr`` keeps the measured per-head SNRs alongside for inspection.
    """

    pfail: float
    k_max: int
    num_blocks: int
    block_size: int
    top_k: Dict[str, np.ndarray]
    snr: Optional[Dict[str, list]] = None

    def route_map(self) -> Dict[str, np.ndarray]:
        """The serve-time per-slot (n_groups, H) int32 head budgets."""
        return {slot: np.asarray(arr, np.int32)
                for slot, arr in self.top_k.items()}

    @property
    def is_uniform(self) -> bool:
        """True when every head kept the static budget — the profile is
        then a routing no-op."""
        return all(np.all(np.asarray(a) == self.k_max)
                   for a in self.top_k.values())

    def summary(self) -> str:
        ks = np.concatenate([np.asarray(a).reshape(-1)
                             for a in self.top_k.values()])
        return (f"routing profile: pfail={self.pfail} k_max={self.k_max} "
                f"heads={ks.size} top_k min/mean/max "
                f"{ks.min()}/{ks.mean():.2f}/{ks.max()}")

    def save(self, path: str) -> None:
        doc = {"version": 1, "pfail": self.pfail, "k_max": self.k_max,
               "num_blocks": self.num_blocks,
               "block_size": self.block_size,
               "top_k": {s: np.asarray(a, np.int32).tolist()
                         for s, a in sorted(self.top_k.items())}}
        if self.snr is not None:
            doc["snr"] = self.snr
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "RoutingProfile":
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        top_k = {s: np.asarray(a, np.int32)
                 for s, a in doc["top_k"].items()}
        for slot, arr in top_k.items():
            if arr.ndim != 2 or arr.size == 0:
                raise ValueError(
                    f"routing profile {path}: slot {slot!r} table must "
                    f"be (n_groups, H), got shape {arr.shape}")
            if arr.min() < 1 or arr.max() > doc["k_max"]:
                raise ValueError(
                    f"routing profile {path}: slot {slot!r} top_k "
                    f"outside [1, k_max={doc['k_max']}]")
        return cls(pfail=float(doc["pfail"]), k_max=int(doc["k_max"]),
                   num_blocks=int(doc["num_blocks"]),
                   block_size=int(doc["block_size"]), top_k=top_k,
                   snr=doc.get("snr"))

    @classmethod
    def uniform(cls, cfg, k: Optional[int] = None) -> "RoutingProfile":
        """A profile that assigns every head the static budget (or
        ``k``): the identity policy."""
        moba = cfg.attention.moba
        pattern = cfg.layer_pattern
        n_groups = cfg.num_layers // len(pattern)
        kk = moba.top_k if k is None else k
        top_k = {f"slot_{i}": np.full((n_groups, cfg.num_heads), kk,
                                      np.int32)
                 for i, kind in enumerate(pattern) if kind == "moba"}
        return cls(pfail=0.0, k_max=moba.top_k, num_blocks=0,
                   block_size=moba.block_size, top_k=top_k)


def calibrate_profile(cfg, params, pfail: float, num_blocks: int,
                      calib_tokens=None, seed: int = 0) -> RoutingProfile:
    """Measure per-(layer, head) SNR on a calibration batch and invert
    the App.-A.4 bound into a :class:`RoutingProfile`.

    ``num_blocks`` is the serve-time routing universe (the engine passes
    its pages per sequence): the bound is evaluated against the pool a
    decode step ranks, not the calibration length.  The forward pass runs
    the port's ``lm_apply`` cache-free on the ``reference`` backend, on
    the device of ``params`` (routing scores do not depend on the
    backend's attention), with the ``core.moba`` capture sink active;
    the captured fp32 scores are copied to numpy.  Captures arrive
    group-major in slot order, which maps them back onto (slot, group).
    """
    from repro_torch.models import transformer as T

    moba = cfg.attention.moba
    if moba is None:
        raise ValueError("adaptive routing needs a MoBA attention config")
    pattern = list(cfg.layer_pattern)
    n_groups = cfg.num_layers // len(pattern)
    moba_slots = [i for i, kind in enumerate(pattern) if kind == "moba"]
    if not moba_slots:
        raise ValueError(
            f"adaptive routing needs at least one moba slot in the "
            f"layer pattern, got {pattern}")
    bs = moba.block_size
    if calib_tokens is None:
        # enough context that the last block sees a real noise population
        n_blk = max(MIN_NOISE_BLOCKS + 2, min(8, max(num_blocks, 1)))
        rng = np.random.default_rng(seed)
        calib_tokens = rng.integers(0, cfg.vocab_size, (2, n_blk * bs),
                                    dtype=np.int32)
    tokens = torch.as_tensor(np.asarray(calib_tokens, np.int32),
                             device=params["embed"].device)
    with capture_routing_scores() as caps, torch.no_grad():
        T.lm_apply(params, tokens, cfg, caches=None, backend="reference")
        caps = [(_as_numpy(s, np.float32), _as_numpy(p, np.int64))
                for s, p in caps]
    expect = len(moba_slots) * n_groups
    if len(caps) != expect:
        raise ValueError(
            f"calibration captured {len(caps)} routing-score tensors, "
            f"expected {expect} ({len(moba_slots)} moba slots x "
            f"{n_groups} groups)")
    top_k: Dict[str, np.ndarray] = {
        f"slot_{i}": np.full((n_groups, cfg.num_heads), moba.top_k,
                             np.int32) for i in moba_slots}
    snr_out: Dict[str, list] = {f"slot_{i}": [[0.0] * cfg.num_heads
                                              for _ in range(n_groups)]
                                for i in moba_slots}
    for ci, (scores, q_pos) in enumerate(caps):
        gi, si = divmod(ci, len(moba_slots))     # group-major capture order
        slot = f"slot_{moba_slots[si]}"
        snr = estimate_head_snr(scores, q_pos, bs)          # (Hkv, G)
        ks = choose_top_k(snr, num_blocks, moba.top_k, pfail)
        top_k[slot][gi] = ks.reshape(-1)                    # h = hkv*G + g
        snr_out[slot][gi] = [round(float(v), 4)
                             for v in snr.reshape(-1)]
    return RoutingProfile(pfail=pfail, k_max=moba.top_k,
                          num_blocks=num_blocks, block_size=bs,
                          top_k=top_k, snr=snr_out)
