"""Query correlation statistic C(D, Q) (paper §3.2.1).

C(D,Q) = E_{(x,p) in Q} [ E_R[ g(x, R) ] - g(x, X_p) ]

with g(x, S) = min_{y in S} dist(x, y) and R a uniformly drawn random subset
of X with |X_p| elements.  Positive C = query vectors are closer to their
true predicate-passing targets than chance (positive correlation); negative
C = the predicate cluster sits away from the query (the regime that breaks
post-filtering).

The reference draws R with ``jax.random``, which torch cannot reproduce;
this module draws with a caller's ``torch.Generator`` and keeps the same
estimator, so the two agree in distribution, not draw for draw.
"""
from __future__ import annotations

import torch

from .bruteforce import masked_topk

Tensor = torch.Tensor


def min_dist(xq: Tensor, x: Tensor, mask: Tensor) -> Tensor:
    """(B,) min squared-L2 distance from each query to masked rows."""
    _, d = masked_topk(xq, x, mask, 1)
    return d[:, 0]


def query_correlation(xq: Tensor, x: Tensor, pass_masks: Tensor,
                      generator: torch.Generator, n_mc: int = 8) -> float:
    """Monte-Carlo estimate of C(D, Q) for a batch of hybrid queries.

    pass_masks: (B, n) bool — X_{p_i} indicator per query; ``generator``
    lives on the tensors' device.  For each query, E_R[g] is estimated by
    drawing ``n_mc`` random subsets of size |X_p| via thresholded uniforms
    (each row kept w.p. |X_p|/n — a binomial surrogate for the
    uniform-without-replacement subset), with one random row forced on
    where a draw keeps none.
    """
    b, n = pass_masks.shape
    dev = pass_masks.device
    p_keep = pass_masks.sum(dim=1).to(torch.float32) / n      # (B,)
    g_true = min_dist(xq, x, pass_masks)
    rows = torch.arange(b, device=dev)

    def one_draw() -> Tensor:
        u = torch.rand((b, n), generator=generator, device=dev)
        rmask = u < p_keep[:, None]
        # guard against empty draws: force one random row on
        any_on = rmask.any(dim=1)
        fallback = torch.randint(0, n, (b,), generator=generator, device=dev)
        rmask[rows, fallback] |= ~any_on
        return min_dist(xq, x, rmask)

    g_rand = torch.stack([one_draw() for _ in range(n_mc)]).mean(dim=0)
    return float((g_rand - g_true).mean())
