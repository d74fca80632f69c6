"""The PyTorch port's graph route against the JAX reference, end to end.

The golden workload of ``tests/test_golden_recall.py`` (same N, D, CARD,
M, M_BETA, EF): the reference builds each variant's graph once per
module, ``graph_from_arrays`` carries it across, and the port's
``hybrid_search`` must return the reference's ids in every
(variant, selectivity) cell, with distances within rtol 1e-5; a differing
slot is allowed only at a near tie, which the test checks.  Recall@10 of
each cell must stay within ±0.02 of ``tests/golden/recall_golden.json``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_golden_recall as golden
from repro.core import ann_search as jax_ann
from repro.core import hybrid_search as jax_search
from repro.core.search import dedup_mask as jax_dedup
from repro.core.search import first_m_true as jax_first_m
from repro.core.search import get_neighbors as jax_get_neighbors
from repro_torch.core import (ann_search, dedup_mask, first_m_true,
                              get_neighbors, ground_truth, hybrid_search,
                              recall_at_k)
from torch_parity import assert_ids_match, port_graph


@pytest.fixture(scope="module")
def workload():
    ds, xq, masks = golden._workload()
    graphs = {v: golden._graph(ds, v) for v in golden.VARIANTS}
    return ds, xq, masks, graphs


@pytest.fixture(scope="module")
def golden_table():
    with open(golden.GOLDEN_PATH) as f:
        return json.load(f)["table"]


@pytest.mark.parametrize("variant", golden.VARIANTS)
@pytest.mark.parametrize("sel", sorted(golden.SELECTIVITIES))
def test_hybrid_search_matches_reference(workload, golden_table, variant,
                                         sel):
    ds, xq, masks, graphs = workload
    kw = dict(k=golden.K, ef=golden.EF, variant=variant, m=golden.M,
              m_beta=golden.M_BETA,
              compressed_level0=variant == "acorn-gamma")
    jids, jd, jst = jax_search(graphs[variant], ds.x, xq, masks[sel], **kw)
    x = torch.from_numpy(np.array(ds.x))
    q = torch.from_numpy(np.array(xq))
    mk = torch.from_numpy(np.array(masks[sel]))
    ids, d, st = hybrid_search(port_graph(graphs[variant]), x, q, mk, **kw)
    ties = assert_ids_match(ids, jids, d, jd, ds.x, xq)
    if not ties:
        assert np.array_equal(st.dist_comps.numpy(),
                              np.asarray(jst.dist_comps))
        assert np.array_equal(st.hops.numpy(), np.asarray(jst.hops))
    rec = recall_at_k(ids, ground_truth(q, x, mk, golden.K))
    want = golden_table[f"{variant}/{sel}"]
    assert abs(rec - want) <= golden.TOL, (rec, want)


def test_ann_search_matches_reference(workload):
    ds, xq, _, graphs = workload
    g = graphs["acorn-1"]
    jids, jd, _ = jax_ann(g, ds.x, xq, k=golden.K, ef=golden.EF, m=golden.M)
    ids, d, _ = ann_search(port_graph(g), torch.from_numpy(np.array(ds.x)),
                           torch.from_numpy(np.array(xq)), k=golden.K,
                           ef=golden.EF, m=golden.M)
    assert_ids_match(ids, jids, d, jd, ds.x, xq)


@pytest.mark.parametrize("strategy", ["plain", "filter", "compress",
                                      "two_hop"])
def test_get_neighbors_matches_reference(workload, strategy):
    ds, _, masks, graphs = workload
    g = graphs["acorn-gamma"]
    tg = port_graph(g)
    pm = np.asarray(masks["s0.500"])[0]
    rng = np.random.default_rng(0)
    vis = rng.random(golden.N) < 0.2
    for c in rng.integers(0, golden.N, size=8):
        want = jax_get_neighbors(g, 0, jnp.int32(c), jnp.asarray(pm),
                                 strategy, golden.M, golden.M_BETA,
                                 visited=jnp.asarray(vis))
        got = get_neighbors(tg, 0, torch.tensor(int(c), dtype=torch.int32),
                            torch.from_numpy(pm.copy()), strategy, golden.M,
                            golden.M_BETA, visited=torch.from_numpy(vis))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_first_m_true_and_dedup_mask_match_reference(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 10, size=24).astype(np.int32)
    ok = rng.random(24) < 0.6
    assert np.array_equal(
        first_m_true(torch.from_numpy(ids), torch.from_numpy(ok), 7).numpy(),
        np.asarray(jax_first_m(jnp.asarray(ids), jnp.asarray(ok), 7)))
    assert np.array_equal(dedup_mask(torch.from_numpy(ids)).numpy(),
                          np.asarray(jax_dedup(jnp.asarray(ids))))
