"""The port's SNR model (``repro_torch.core.snr``) against the JAX
package's ``repro.core.snr``.

The formulas are plain Python in both packages and must agree exactly,
``_norm_ppf`` at and around the branch points of its rational
approximation included.  ``empirical_retrieval`` runs on tensors with
``lax.top_k``'s tie order, so on the same numpy keys it gives JAX's
answer, ties included.  The port's planted-problem generator (its own
``torch.Generator``, not JAX's stream) must reproduce the model's
per-pair failure rate ``p_fail`` within a binomial tolerance.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import snr as JS
from repro_torch.core import snr as TS

FORMULA_CASES = [(64, 128, 0.6), (64, 16, 0.25), (128, 512, 1.3),
                 (32, 64, 0.0), (16, 32, 2.0)]


@pytest.mark.parametrize("d,bs,gap", FORMULA_CASES)
def test_formulas_equal_jax(d, bs, gap):
    assert TS.snr(d, bs, gap) == JS.snr(d, bs, gap)
    assert TS.p_fail(d, bs, gap) == JS.p_fail(d, bs, gap)
    for m, mu_c, mu_n in ((1, 0.9, 0.1), (4, 0.3, 0.0), (8, 0.0, 0.2)):
        assert TS.effective_gap(gap, m, mu_c, mu_n) == \
            JS.effective_gap(gap, m, mu_c, mu_n)
    for n, k in ((64, 1), (64, 8), (1024, 16), (16, 8), (33, 32)):
        assert TS.required_snr(n, k) == JS.required_snr(n, k)


_PLOW = 0.02425


@pytest.mark.parametrize("p", [
    1e-9, 1e-6, _PLOW - 1e-9, _PLOW, _PLOW + 1e-9, 0.1, 0.5 - 1e-12, 0.5,
    0.9, 1 - _PLOW - 1e-9, 1 - _PLOW, 1 - _PLOW + 1e-9, 1 - 1e-6,
    1 - 1e-9])
def test_norm_ppf_equals_jax_at_branch_points(p):
    assert TS._norm_ppf(p) == JS._norm_ppf(p)


@pytest.mark.parametrize("p", [0.0, 1.0, -0.1, 1.1])
def test_norm_ppf_domain(p):
    with pytest.raises(ValueError, match="p in"):
        TS._norm_ppf(p)
    with pytest.raises(ValueError):
        TS.required_snr(64, 64)          # k == n: q = 0, outside (0, 1)


def _as_port(problem) -> TS.PlantedProblem:
    return TS.PlantedProblem(torch.from_numpy(np.array(problem.q)),
                             torch.from_numpy(np.array(problem.keys)),
                             int(problem.signal_block))


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_empirical_retrieval_equals_jax(top_k):
    """JAX's planted problems as numpy, scored by both packages; a weak
    signal (delta 0.2) so that both outcomes occur."""
    outcomes = []
    key = jax.random.PRNGKey(3)
    for t in range(24):
        key, sub = jax.random.split(key)
        prob = JS.make_planted_problem(sub, 512, 32, 32, 0.2, m=2,
                                       mu_cluster=0.3, signal_block=t % 16)
        want = bool(JS.empirical_retrieval(prob, 32, top_k))
        assert TS.empirical_retrieval(_as_port(prob), 32, top_k) == want
        outcomes.append(want)
    assert len(set(outcomes)) == 2, "the cases should hit and miss"


@pytest.mark.parametrize("signal_block", [0, 2, 5])
def test_empirical_retrieval_tie_order_equals_jax(signal_block):
    """Every block's centroid scores the same: the top-k is the lowest
    block ids, as lax.top_k breaks ties."""
    keys = np.tile(np.eye(8, dtype=np.float32)[:1], (64, 1))
    q = np.eye(8, dtype=np.float32)[0]
    jprob = JS.PlantedProblem(jax.numpy.asarray(q), jax.numpy.asarray(keys),
                              signal_block)
    for top_k in (1, 3, 6):
        want = bool(JS.empirical_retrieval(jprob, 8, top_k))
        assert want == (signal_block < top_k)
        assert TS.empirical_retrieval(_as_port(jprob), 8, top_k) == want


def test_planted_problem_geometry():
    gen = torch.Generator().manual_seed(0)
    prob = TS.make_planted_problem(gen, 256, 64, 32, 0.6, m=4,
                                   mu_cluster=0.3, signal_block=3)
    assert prob.keys.shape == (256, 64) and prob.signal_block == 3
    norms = torch.linalg.norm(prob.keys, dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    dots = prob.keys[96:100] @ prob.q
    assert torch.allclose(dots, torch.tensor([0.6, 0.3, 0.3, 0.3]),
                          atol=1e-5)


@pytest.mark.parametrize("d,bs,m,mu_c,delta", [
    (64, 64, 1, 0.0, 0.6),        # fig2_snr's first row family
    (64, 128, 4, 0.3, 0.6),       # clustered signal, Δμ_eff 1.5
])
def test_planted_failure_rate_matches_p_fail(d, bs, m, mu_c, delta):
    """Two blocks a problem (the signal's and one noise block), so each
    trial is one independent pairwise comparison: the count of noise
    wins is Binomial(trials, p_fail) under the model; held within 4
    standard deviations."""
    trials = 1500
    gen = torch.Generator().manual_seed(11)
    fails = 0
    for t in range(trials):
        prob = TS.make_planted_problem(gen, 2 * bs, d, bs, delta, m=m,
                                       mu_cluster=mu_c, signal_block=t % 2)
        cents = prob.keys.reshape(2, bs, d).mean(dim=1)
        scores = cents @ prob.q
        fails += int(scores[1 - prob.signal_block]
                     > scores[prob.signal_block])
    p = TS.p_fail(d, bs, TS.effective_gap(delta, m, mu_c))
    tol = 4 * math.sqrt(p * (1 - p) / trials)
    assert abs(fails / trials - p) <= tol, (fails / trials, p, tol)
