"""The PyTorch port's query-correlation statistic against the JAX
reference.

``min_dist`` is exact and must agree within fp32 (rtol 1e-5, atol 1e-5:
the two packages' distance matmuls sum in different orders).
``query_correlation`` draws its random subsets with a ``torch.Generator``,
which cannot reproduce ``jax.random``, so it is held to the reference in
distribution: the sign on positively and negatively correlated workloads,
and the mean over many one-draw estimates within 3 Monte-Carlo standard
errors of the reference's, the errors computed from both sets of draws.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core.correlation as JC
import repro_torch.core as T
from repro.data import make_hcps_dataset, make_workload

DRAWS = 40


@pytest.fixture(scope="module")
def workloads():
    ds = make_hcps_dataset(n=1500, d=8, seed=0)
    out = {}
    for cor in ("pos", "neg", "none"):
        wl = make_workload(ds, kind="contains", correlation=cor,
                           n_queries=24, seed=1)
        out[cor] = (np.array(wl.xq), np.array(wl.masks(ds)))
    return np.array(ds.x), out


def test_min_dist_matches(workloads):
    x, wls = workloads
    for xq, masks in wls.values():
        want = np.asarray(JC.min_dist(xq, x, masks))
        got = T.min_dist(torch.as_tensor(xq), torch.as_tensor(x),
                         torch.as_tensor(masks))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _draws(xq, x, masks):
    """One-draw estimates of C from each package: DRAWS each."""
    tq, tx, tm = (torch.as_tensor(a) for a in (xq, x, masks))
    port = [T.query_correlation(tq, tx, tm,
                                torch.Generator().manual_seed(i), n_mc=1)
            for i in range(DRAWS)]
    ref = [JC.query_correlation(xq, x, masks, jax.random.PRNGKey(i), n_mc=1)
           for i in range(DRAWS)]
    return np.asarray(port), np.asarray(ref)


@pytest.mark.parametrize("cor", ["pos", "neg", "none"])
def test_query_correlation_agrees_in_distribution(workloads, cor):
    x, wls = workloads
    xq, masks = wls[cor]
    port, ref = _draws(xq, x, masks)
    se = np.sqrt(port.var(ddof=1) / DRAWS + ref.var(ddof=1) / DRAWS)
    assert abs(port.mean() - ref.mean()) <= 3 * se, (port.mean(),
                                                     ref.mean(), se)
    if cor != "none":   # the sign of the reference's estimate
        want = JC.query_correlation(xq, x, masks, jax.random.PRNGKey(99))
        got = T.query_correlation(*(torch.as_tensor(a)
                                    for a in (xq, x, masks)),
                                  torch.Generator().manual_seed(99))
        assert np.sign(got) == np.sign(want) == (1 if cor == "pos" else -1)


def test_empty_draw_guard():
    """A query whose pass mask keeps nearly nothing still gets a finite
    random-subset distance: an empty draw forces one row on."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(500, 4)).astype(np.float32))
    masks = torch.zeros((3, 500), dtype=torch.bool)
    masks[:, 7] = True
    c = T.query_correlation(x[:3] + 0.01, x, masks,
                            torch.Generator().manual_seed(0), n_mc=4)
    assert np.isfinite(c)
