"""Attention-backend registry: one seam for every attention implementation.

An :class:`AttentionBackend` declares its :class:`Capabilities`
(attention kinds × prefill/decode phases × dense/paged cache protocols)
and call sites select by *name + capability query* via :func:`resolve`.

Registered backends of the port:

  reference     O(N²) masked-softmax oracle (``core/moba.py``)
  xla           plain PyTorch gather-and-densify (``kernels/ref.py::
                moba_sparse_xla``, differentiable) and the plain paged
                paths (alias: ``sparse``) — the name is the reference's
  flash         Hopper kernels: FlashMoBA for cache-free (training)
                attention (``kernels/ops.py::flash_moba``, four CUDA
                kernels) and the CUDA paged-decode kernel
                (``kernels/moba_decode.py``) (alias: ``kernel``)
  sp            sequence-parallel training and prefill and
                context-parallel decode over the shards of the active
                ``distributed/moba_sp.py`` group (dense caches only)
                (alias: ``sp_unrolled``)
  sharded       the sharded engine's backend: per-shard paged math
                delegated to a shard-free ``inner`` backend (``xla``)

Dense and sliding-window kinds share one implementation across backends
(base-class methods); MoBA is where backends differ.  Paged *prefill* is
shared too: the ragged reference path is the only implementation with
per-sequence ``kv_len`` masking.  The ``dense`` cache protocol covers
cache-free attention (training) and the dense per-sequence KV cache of
the fixed serving loop; its MoBA decode (:meth:`AttentionBackend.
moba_decode`) is the plain gather on every backend, ``flash`` included,
as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.core.attention import dense_attention
from repro_torch.core.moba import (moba_attention_reference,
                                   moba_decode_attention,
                                   moba_paged_decode_attention,
                                   moba_paged_prefill_attention)
from repro_torch.core.quantization import KV_DTYPES

KINDS = ("dense", "swa", "moba")
PHASES = ("prefill", "decode")
CACHES = ("dense", "paged")


class BackendCapabilityError(ValueError):
    """Requested (backend, kind, phase, cache) combination is unsupported.

    The message names the backends that *do* support the combination."""


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can run.  ``caches`` uses 'dense' for the
    cache-free (training) path and the fixed loop's dense per-sequence
    caches, and 'paged' for the serving engine's block-table pools.

    ``key_conv`` lists the cache protocols under which the backend can
    consume key-conv'd keys.  The conv itself runs in
    ``models/layers.py`` before keys reach any backend; paged caches
    also need the pool's per-slot raw-key ring, so a backend declares
    the protocols whose conv-state plumbing it is validated against.

    ``kv_dtypes`` lists the paged-pool storage dtypes the backend's
    paged paths are validated against (``core/quantization.py``):
    ``int8``/``fp8`` pools carry per-page scale leaves the backend must
    dequantize with.  Default is fp32-only, so an unvalidated backend
    fails at admission, not with wrong attention output.

    ``sharded`` declares that the backend's per-shard math needs nothing
    from the other shards, so the sharded engine may run it once per
    shard (``serving/sharded.py``).  The ``sp`` backends move data
    between shards themselves and are refused there.

    ``adaptive_topk`` declares that the backend's paged MoBA paths honor
    per-(layer, head) ``head_top_k`` budgets (SNR-guided adaptive
    routing, ``core/adaptive.py``).  The context-parallel ``sp``
    backends' distributed selection has no per-head budgets."""

    kinds: Tuple[str, ...] = KINDS
    phases: Tuple[str, ...] = PHASES
    caches: Tuple[str, ...] = CACHES
    key_conv: Tuple[str, ...] = CACHES
    sharded: bool = True
    kv_dtypes: Tuple[str, ...] = ("fp32",)
    adaptive_topk: bool = True

    def supports(self, kind: str, phase: str, cache: str = "dense",
                 key_conv: bool = False, sharded: bool = False,
                 kv_dtype: str = "fp32", adaptive: bool = False) -> bool:
        return (kind in self.kinds and phase in self.phases
                and cache in self.caches
                and (not key_conv or cache in self.key_conv)
                and (not sharded or self.sharded)
                and kv_dtype in self.kv_dtypes
                and (not adaptive or self.adaptive_topk))


class AttentionBackend:
    """Protocol + shared implementations.  Subclasses override the
    ``moba_*`` hooks; dense/swa attention and paged prefill are shared."""

    name: str = ""
    aliases: Tuple[str, ...] = ()
    capabilities: Capabilities = Capabilities()

    @staticmethod
    def _window(cfg: AttentionConfig, kind: str) -> int:
        return cfg.window if kind == "swa" else 0

    # ------------------------------------------- full sequence / dense KV
    def prefill(self, cfg: AttentionConfig, kind: str, q, k, v, *,
                q_positions=None, kv_len=None,
                causal: bool = True) -> torch.Tensor:
        """Multi-token attention: training, prefill, or cached prefill
        (``kv_len`` marks the valid prefix of a dense cache; MoBA callers
        pass only the valid prefix, see ``models/layers.py``)."""
        if kind == "moba":
            # ``causal`` reaches dense attention only: MoBA's mask is
            # ``MoBAConfig.causal``, as in the reference, so the
            # encoder-decoder family's ``causal=False`` encoder still runs
            # causal MoBA (ROADMAP.md §C)
            return self.moba_prefill(cfg, q, k, v, q_positions=q_positions)
        return dense_attention(q, k, v, causal=causal,
                               q_positions=q_positions, kv_len=kv_len,
                               window=self._window(cfg, kind),
                               scale=cfg.scale)

    def decode(self, cfg: AttentionConfig, kind: str, q, k, v, kv_len, *,
               centroids=None, q_positions=None) -> torch.Tensor:
        """Single-token attention against a dense cache of which the first
        ``kv_len`` positions are valid."""
        if kind == "moba":
            return self.moba_decode(cfg, q, k, v, kv_len,
                                    centroids=centroids)
        return dense_attention(q, k, v, causal=True,
                               q_positions=q_positions, kv_len=kv_len,
                               window=self._window(cfg, kind),
                               scale=cfg.scale)

    # --------------------------------------------------------- paged KV
    # ``head_top_k`` of the paged paths: (Hkv, G) int32 per-head MoBA
    # budgets of an adaptive routing profile, or None (static top_k);
    # the dense and swa kinds ignore it.
    def paged_prefill(self, cfg: AttentionConfig, kind: str, q, k, v, *,
                      post_len, positions, head_top_k=None) -> torch.Tensor:
        """Ragged fresh prefill (right-padded rows; ``post_len`` is the
        per-sequence valid length after this step)."""
        if kind == "moba":
            return moba_attention_reference(
                q, k, v, cfg.moba, q_positions=positions,
                kv_len=post_len[:, None, None, None], scale=cfg.scale,
                head_top_k=head_top_k)
        return dense_attention(q, k, v, causal=True, q_positions=positions,
                               kv_len=post_len,
                               window=self._window(cfg, kind),
                               scale=cfg.scale)

    def paged_chunk_prefill(self, cfg: AttentionConfig, kind: str, q, cache,
                            block_table, kv_len, q_len, *,
                            head_top_k=None) -> torch.Tensor:
        """Chunked prefill: multi-token attention for a ragged chunk whose
        K/V (and every earlier chunk's) are already appended to ``cache``;
        query i,j sits at position ``kv_len[i] + j``."""
        from repro_torch.serving import paged_cache as PC
        if kind == "moba":
            return moba_paged_prefill_attention(
                q, cache["pages_k"], cache["pages_v"], cache["centroids"],
                block_table, kv_len, q_len, cfg.moba, scale=cfg.scale,
                scales_k=cache.get("scales_k"),
                scales_v=cache.get("scales_v"), head_top_k=head_top_k)
        kf, vf = PC.paged_gather_kv(cache, block_table)
        positions = kv_len[:, None] + torch.arange(q.shape[2],
                                                   device=q.device)
        return dense_attention(q, kf, vf, causal=True,
                               q_positions=positions,
                               kv_len=kv_len + q_len,
                               window=self._window(cfg, kind),
                               scale=cfg.scale)

    def paged_decode(self, cfg: AttentionConfig, kind: str, q, cache,
                     block_table, kv_len, *, positions=None,
                     head_top_k=None) -> torch.Tensor:
        """Single-token attention against a paged pool through the block
        table.  ``kv_len`` is the post-append per-sequence length."""
        from repro_torch.serving import paged_cache as PC
        if kind == "moba":
            return self.moba_paged_decode(cfg, q, cache, block_table,
                                          kv_len, head_top_k=head_top_k)
        if kind == "swa":
            return PC.swa_windowed_decode_attention(
                q, cache, block_table, kv_len, cfg.window, scale=cfg.scale)
        kf, vf = PC.paged_gather_kv(cache, block_table)
        return dense_attention(q, kf, vf, causal=True,
                               q_positions=positions, kv_len=kv_len,
                               scale=cfg.scale)

    # ------------------------------------------------ MoBA-specific hooks
    def moba_prefill(self, cfg: AttentionConfig, q, k, v, *,
                     q_positions=None) -> torch.Tensor:
        raise NotImplementedError(f"{self.name}: moba prefill")

    def moba_decode(self, cfg: AttentionConfig, q, k, v, kv_len, *,
                    centroids=None) -> torch.Tensor:
        # block routing is implementation-independent at decode: the
        # plain gather is every backend's dense-cache decode
        return moba_decode_attention(q, k, v, kv_len, cfg.moba,
                                     scale=cfg.scale, centroids=centroids)

    def moba_paged_decode(self, cfg: AttentionConfig, q, cache, block_table,
                          kv_len, head_top_k=None) -> torch.Tensor:
        return moba_paged_decode_attention(
            q, cache["pages_k"], cache["pages_v"], cache["centroids"],
            block_table, kv_len, cfg.moba, scale=cfg.scale,
            scales_k=cache.get("scales_k"), scales_v=cache.get("scales_v"),
            head_top_k=head_top_k)


class ReferenceBackend(AttentionBackend):
    """O(N²) masked-softmax oracle — the correctness anchor."""

    name = "reference"

    def moba_prefill(self, cfg, q, k, v, *, q_positions=None):
        return moba_attention_reference(q, k, v, cfg.moba,
                                        q_positions=q_positions,
                                        scale=cfg.scale)


class XLABackend(AttentionBackend):
    """Plain PyTorch gather-and-densify (the reference's ``xla`` backend),
    differentiable through torch autograd."""

    name = "xla"
    aliases = ("sparse",)
    capabilities = Capabilities(kv_dtypes=KV_DTYPES)

    def moba_prefill(self, cfg, q, k, v, *, q_positions=None):
        from repro_torch.kernels import ref
        return ref.moba_sparse_xla(q, k, v, cfg.moba,
                                   q_positions=q_positions, scale=cfg.scale)


class FlashBackend(AttentionBackend):
    """Hopper kernel path: FlashMoBA for cache-free and dense-cache
    prefill attention, the banded SWA kernels for the SWA layers' training
    attention, and the paged MoBA decode kernel (CPU tensors take the
    kernels' plain versions).  Dense-cache decode keeps the shared plain
    gather, as the reference's Pallas backend does.
    ``train_grid``, ``kb_tile`` and ``decode_grid`` keep the reference's
    options; both grid values reach the one Hopper kernel of each
    function."""

    name = "flash"
    aliases = ("kernel",)
    capabilities = Capabilities(kv_dtypes=KV_DTYPES)
    decode_grid: str = "grouped"
    train_grid: str = "grouped"
    # forward K/V streaming granularity, 0 = auto (min(block_size, 128))
    kb_tile: int = 0

    def prefill(self, cfg, kind, q, k, v, *, q_positions=None, kv_len=None,
                causal=True):
        """SWA attention of a sequence over its own keys (training, a
        one-shot prefill: ``kernels/swa.py::training_case``) runs the
        banded kernels, forward and backward (CPU tensors their plain
        versions); every other call the shared paths."""
        from repro_torch.kernels import swa
        if kind == "swa" and swa.training_case(
                q, k, v, causal=causal, q_positions=q_positions,
                kv_len=kv_len):
            return swa.banded_attention(q, k, v, cfg.window, scale=cfg.scale)
        return super().prefill(cfg, kind, q, k, v, q_positions=q_positions,
                               kv_len=kv_len, causal=causal)

    def moba_prefill(self, cfg, q, k, v, *, q_positions=None):
        from repro_torch.kernels import ops
        return ops.flash_moba(q, k, v, cfg.moba, q_positions=q_positions,
                              scale=cfg.scale, kb_tile=self.kb_tile,
                              grid=self.train_grid)

    def moba_paged_decode(self, cfg, q, cache, block_table, kv_len,
                          head_top_k=None):
        from repro_torch.kernels import moba_decode
        return moba_decode.moba_paged_decode(
            q, cache["pages_k"], cache["pages_v"], cache["centroids"],
            block_table, kv_len, cfg.moba, scale=cfg.scale,
            grid=self.decode_grid, scales_k=cache.get("scales_k"),
            scales_v=cache.get("scales_v"), head_top_k=head_top_k)


class SPBackend(AttentionBackend):
    """Sequence-parallel training and prefill and context-parallel decode
    (``distributed/moba_sp.py``) over the shards of the active group
    (``moba_sp.use_group``; none active: the single-device plain paths).
    Training runs through it: ``make_train_step(cfg, tcfg, backend="sp")``
    called under ``use_group`` differentiates the MoBA layers through
    the shards, each recomputing its attention in the backward; the
    dense and SWA layers run ``dense_attention`` on the lead, as in the
    reference.  Dense caches only, and never inside the sharded
    engine's per-shard steps, since it moves data between shards itself:
    the sharded engine runs it around the paged path as the fallback for
    requests longer than one shard's pool.  ``sp_unrolled`` names the reference's
    unrolled twin (a Python loop where ``sp`` scans); the port's tile
    loop is one eager loop either way, so it is an alias."""

    name = "sp"
    aliases = ("sp_unrolled",)
    capabilities = Capabilities(caches=("dense",), key_conv=("dense",),
                                sharded=False, adaptive_topk=False)

    def moba_prefill(self, cfg, q, k, v, *, q_positions=None):
        from repro_torch.distributed.moba_sp import moba_attention_sp
        return moba_attention_sp(q, k, v, cfg.moba, scale=cfg.scale,
                                 q_positions=q_positions)

    def moba_decode(self, cfg, q, k, v, kv_len, *, centroids=None):
        from repro_torch.distributed.moba_sp import moba_decode_cp
        return moba_decode_cp(q, k, v, kv_len, cfg.moba, scale=cfg.scale,
                              centroids=centroids)


class ShardedBackend(AttentionBackend):
    """The backend the sharded engine resolves by default: per-shard
    attention math delegated to a shard-free ``inner`` backend (default
    ``xla``).  The sharding lives in the sharded engine (one engine a
    shard, ``serving/sharded.py``), not in the math, which is why a
    shard's tokens equal the single-device engine's.  On one device it is just
    ``inner``."""

    name = "sharded"
    capabilities = Capabilities(kv_dtypes=KV_DTYPES)
    inner = "xla"

    def _inner(self) -> AttentionBackend:
        return get(self.inner)

    def moba_prefill(self, cfg, q, k, v, *, q_positions=None):
        return self._inner().moba_prefill(cfg, q, k, v,
                                          q_positions=q_positions)

    def moba_decode(self, cfg, q, k, v, kv_len, *, centroids=None):
        return self._inner().moba_decode(cfg, q, k, v, kv_len,
                                         centroids=centroids)

    def moba_paged_decode(self, cfg, q, cache, block_table, kv_len,
                          head_top_k=None):
        return self._inner().moba_paged_decode(cfg, q, cache, block_table,
                                               kv_len, head_top_k=head_top_k)


# ---------------------------------------------------------------- registry
_REGISTRY: Dict[str, AttentionBackend] = {}
_ALIASES: Dict[str, str] = {}


def register(backend: AttentionBackend) -> AttentionBackend:
    if not backend.name:
        raise ValueError("backend must set a name")
    for key in (backend.name,) + backend.aliases:
        taken = _ALIASES.get(key)
        if taken is not None and taken != backend.name:
            raise ValueError(f"backend name/alias {key!r} already "
                             f"registered for {taken!r}")
    _REGISTRY[backend.name] = backend
    for key in (backend.name,) + backend.aliases:
        _ALIASES[key] = backend.name
    return backend


def names() -> Tuple[str, ...]:
    """Canonical backend names (aliases excluded), registration order."""
    return tuple(_REGISTRY)


def get(name: str) -> AttentionBackend:
    canonical = _ALIASES.get(name)
    if canonical is None:
        raise BackendCapabilityError(
            f"unknown attention backend {name!r}; registered: "
            f"{sorted(_ALIASES)}")
    return _REGISTRY[canonical]


def parse_backend_spec(spec: str) -> str:
    """``name[:option,...]`` → registered backend name, applying each
    option to the backend instance.  Options: ``grouped`` / ``flat`` set
    both the paged-decode grid (``decode_grid``) and the training grid
    (``train_grid``) of backends that carry them; ``kb_tile=N`` sets the
    forward's K/V streaming granularity (0 = auto).  Unknown names or
    options raise :class:`BackendCapabilityError`."""
    name, _, optstr = spec.partition(":")
    if not optstr:
        return name
    be = get(name)
    for opt in optstr.split(","):
        opt = opt.strip()
        if opt in ("grouped", "flat"):
            if not hasattr(be, "decode_grid") \
                    and not hasattr(be, "train_grid"):
                raise BackendCapabilityError(
                    f"backend {be.name!r} has no decode-grid option; "
                    f"got {spec!r}")
            if hasattr(be, "decode_grid"):
                be.decode_grid = opt
            if hasattr(be, "train_grid"):
                be.train_grid = opt
        elif opt.startswith("kb_tile="):
            if not hasattr(be, "kb_tile"):
                raise BackendCapabilityError(
                    f"backend {be.name!r} has no kb_tile option (only the "
                    f"kernel training path does); got {spec!r}")
            try:
                be.kb_tile = int(opt.split("=", 1)[1])
            except ValueError:
                raise BackendCapabilityError(
                    f"unknown backend option {opt!r} in {spec!r}: "
                    f"kb_tile takes an integer (0 = auto)") from None
        else:
            raise BackendCapabilityError(
                f"unknown backend option {opt!r} in {spec!r}; expected "
                f"grouped | flat | kb_tile=N")
    return name


def resolve_backend_spec(spec, *, default: str = "reference") -> str:
    """THE backend-spec resolver every surface shares: an empty/None
    ``spec`` falls back to ``default``; otherwise the ``name[:option,...]``
    string is parsed and the name validated eagerly against the registry.
    Returns the backend name as given (aliases preserved)."""
    spec = (spec or "").strip() or default
    name = parse_backend_spec(spec)
    get(name)
    return name


def resolve(name: str, *, kind: str, phase: str, cache: str = "dense",
            key_conv: bool = False, sharded: bool = False,
            kv_dtype: str = "fp32", adaptive: bool = False
            ) -> AttentionBackend:
    """Name + capability query: the single entry point call sites use.
    ``key_conv=True`` demands key-conv support under ``cache``;
    ``sharded=True`` per-shard math that needs no other shard;
    ``kv_dtype`` of ``int8``/``fp8`` demands quantized-pool support
    (per-page scale dequantization in every paged path);
    ``adaptive=True`` demands per-head ``head_top_k`` routing support."""
    be = get(name)
    query = (kind, phase, cache, key_conv, sharded, kv_dtype, adaptive)
    if not be.capabilities.supports(*query):
        able = [b.name for b in _REGISTRY.values()
                if b.capabilities.supports(*query)]
        raise BackendCapabilityError(
            f"backend {be.name!r} does not support kind={kind!r} "
            f"phase={phase!r} cache={cache!r} key_conv={key_conv} "
            f"sharded={sharded} kv_dtype={kv_dtype!r} adaptive={adaptive}; "
            f"backends that do: {able}")
    return be


for _be in (ReferenceBackend(), XLABackend(), FlashBackend(), SPBackend(),
            ShardedBackend()):
    register(_be)


def capability_matrix() -> str:
    """Human-readable support table, one row a registered backend."""
    lines = [f"{'backend':<14}{'aliases':<22}{'kinds':<18}"
             f"{'phases':<18}{'caches':<14}{'key_conv':<14}"
             f"{'sharded':<10}{'adaptive':<10}kv_dtypes"]
    for be in _REGISTRY.values():
        c = be.capabilities
        lines.append(f"{be.name:<14}{','.join(be.aliases) or '-':<22}"
                     f"{','.join(c.kinds):<18}{','.join(c.phases):<18}"
                     f"{','.join(c.caches):<14}{','.join(c.key_conv):<14}"
                     f"{'yes' if c.sharded else '-':<10}"
                     f"{'yes' if c.adaptive_topk else '-':<10}"
                     f"{','.join(c.kv_dtypes)}")
    return "\n".join(lines)


_DOCS_BEGIN = "<!-- capability-matrix:begin (generated) -->"
_DOCS_END = "<!-- capability-matrix:end -->"


def sync_docs(path: str) -> bool:
    """Rewrite the generated capability-matrix block of the file at
    ``path`` (between the begin and end markers) from the registry.
    Returns True when the file changed."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    b, e = text.index(_DOCS_BEGIN), text.index(_DOCS_END)
    new = (text[:b] + f"{_DOCS_BEGIN}\n```\n{capability_matrix()}\n```\n"
           + text[e:])
    if new == text:
        return False
    with open(path, "w", encoding="utf-8") as f:
        f.write(new)
    return True
