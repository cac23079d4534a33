"""The paper's statistical model of MoBA block selection (Section 3 and
App. A).

SNR = Δμ_eff · sqrt(d / 2B),   p_fail = Φ(−SNR)
Δμ_eff = Δμ + (m−1)(μ_cluster − μ_noise)

The formulas are plain Python.  The planted-signal generator (the
generative model of App. A) and its retrieval check run on tensors, from
an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.routing import topk_desc


def effective_gap(delta_mu: float, m: int = 1, mu_cluster: float = 0.0,
                  mu_noise: float = 0.0) -> float:
    """Δμ_eff with m clustered signal tokens (paper Eq. after (2))."""
    return delta_mu + (m - 1) * (mu_cluster - mu_noise)


def snr(d: int, block_size: int, delta_mu_eff: float) -> float:
    """Central formula, paper Eq. (3)."""
    return delta_mu_eff * math.sqrt(d / (2.0 * block_size))


def p_fail(d: int, block_size: int, delta_mu_eff: float) -> float:
    """Probability a single noise block outranks the signal block:
    Φ(−SNR)."""
    return 0.5 * math.erfc(snr(d, block_size, delta_mu_eff) / math.sqrt(2.0))


def required_snr(num_blocks: int, top_k: int) -> float:
    """SNR needed for reliable top-k retrieval among n blocks:
    SNR > Φ⁻¹(1 − k/n)  (paper App. A.4)."""
    return _norm_ppf(1.0 - top_k / num_blocks)


def _norm_ppf(p: float) -> float:
    """Inverse normal CDF, Peter Acklam's rational approximation
    (|eps| < 4.5e-4 relative)."""
    if not 0.0 < p < 1.0:
        raise ValueError("p in (0,1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    dd = [7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow or p > phigh:
        # tails: the same rational function of sqrt(-2 log(tail mass))
        ql = math.sqrt(-2 * math.log(p if p < plow else 1 - p))
        num = ((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4])
        num = num * ql + c[5]
        den = (((dd[0] * ql + dd[1]) * ql + dd[2]) * ql + dd[3]) * ql + 1
        return num / den if p < plow else -num / den
    ql = p - 0.5
    r = ql * ql
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
    num = (num * r + a[5]) * ql
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
    return num / den


class PlantedProblem(NamedTuple):
    """Synthetic retrieval instance matching App. A's generative model."""
    q: torch.Tensor       # (d,)
    keys: torch.Tensor    # (N, d)
    signal_block: int


def _plant(vec: torch.Tensor, q: torch.Tensor, mu: float) -> torch.Tensor:
    """A unit vector whose component along ``q`` is ``mu`` and whose
    orthogonal part keeps ``vec``'s direction (mu < 1 assumed)."""
    orth = vec - (vec @ q) * q
    orth = orth / torch.linalg.norm(orth)
    return mu * q + math.sqrt(max(1.0 - mu * mu, 1e-9)) * orth


def make_planted_problem(gen: torch.Generator, n_tokens: int, d: int,
                         block_size: int, delta_mu: float, m: int = 1,
                         mu_cluster: float = 0.0,
                         signal_block: int = 0) -> PlantedProblem:
    """Noise keys uniform on the sphere (q·k ~ mean 0, var 1/d after
    normalization); a signal key with E[q·k*] = delta_mu and m−1
    clustered keys at affinity mu_cluster, all in ``signal_block``.
    Tensors are fp32 on ``gen``'s device."""
    dev = gen.device
    q = torch.randn((d,), generator=gen, device=dev)
    q = q / torch.linalg.norm(q)
    keys = torch.randn((n_tokens, d), generator=gen, device=dev)
    keys = keys / torch.linalg.norm(keys, dim=-1, keepdim=True)
    base = signal_block * block_size
    keys[base] = _plant(keys[base], q, delta_mu)
    for i in range(1, m):
        keys[base + i] = _plant(keys[base + i], q, mu_cluster)
    return PlantedProblem(q, keys, signal_block)


def empirical_retrieval(problem: PlantedProblem, block_size: int,
                        top_k: int) -> bool:
    """True iff the signal block ranks in the top-k by centroid score
    (the event whose failure probability the theory predicts); ties go
    to the lower block, as ``lax.top_k`` breaks them."""
    n = problem.keys.shape[0]
    nb = n // block_size
    cents = problem.keys.reshape(nb, block_size, -1).mean(dim=1)
    scores = cents @ problem.q
    top = topk_desc(scores, top_k)[1]
    return bool((top == problem.signal_block).any())
