"""``chip_smoke.py``'s baselines and incremental phases on CPU tensors.

Both phases must run to their end at a tiny corpus on the CPU, where no
kernel launches: the three builds of Figure 7's baselines, every method
at every ef of the sweep with its checks (ids pass their predicates,
pre-filter recall, the full CPU-copy parity of a method below the last
ef's recall floor), the 16-query CPU-copy parity, the
``build_hnsw`` parity and Table 4's incremental builds with their
prefix parity.  The phase's near-tie helpers must accept what a near tie
explains and refuse what it does not.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _chip_smoke():
    """chip_smoke.py, loaded from the repo root (it imports no torch or
    JAX at module level)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lcps():
    from repro_torch.core import (AcornConfig, HybridIndex, masked_topk)
    from repro_torch.data import make_lcps_dataset, make_workload
    smoke = _chip_smoke()
    dev = torch.device("cpu")
    ds = make_lcps_dataset(n=1200, d=8, card=smoke.CARD, seed=0, device=dev)
    index = HybridIndex.build(ds.x, ds.table, AcornConfig(M=8, gamma=4),
                              seed=0, device=dev)
    wl = make_workload(ds, kind="equals", n_queries=24, seed=1,
                       card=smoke.CARD)
    masks = wl.masks(ds)
    gt, _ = masked_topk(wl.xq, index.x, masks, smoke.K)
    labels = np.array([p.value for p in wl.predicates])
    return smoke, dev, index, wl, masks, gt, labels


def test_baselines_phase_runs_on_cpu_tensors(lcps, capsys, monkeypatch):
    smoke, dev, index, wl, masks, gt, labels = lcps
    monkeypatch.setattr(smoke, "M", 8)          # the tiny index's M, M_β
    monkeypatch.setattr(smoke, "M_BETA", 16)
    # every method below the floor: each must then match its CPU copy on
    # every query at the last ef
    monkeypatch.setattr(smoke, "BASE_RECALL_FLOOR", 1.01)
    built = smoke.baselines_build(dev, index.x, index.table.int_cols["label"],
                                  m=8, efc=16)
    assert set(built) == {"acorn-1", "hnsw", "oracle"}
    assert len(built["oracle"].partitions) == smoke.CARD
    launches = smoke.baselines_search(dev, index.x, index.graph, built,
                                      wl.xq, masks, labels, gt,
                                      ef_sweep=(16, 32), n_parity=4)
    assert set(launches) == {"acorn-gamma", "acorn-1", "postfilter",
                             "oracle"}
    assert all(set(c.values()) == {0} for c in launches.values())
    out = capsys.readouterr().out
    for line in ("build=acorn-1", "build=hnsw", "build=oracle",
                 "method=postfilter ef=32", "method=oracle ef=16",
                 "method=prefilter", "qps_at_recall=0.9",
                 "[parity] path=baselines method=oracle",
                 "[parity] path=baselines method=acorn-1 ef=32 queries=24"):
        assert line in out, line


def test_build_hnsw_parity_on_cpu_tensors(lcps):
    smoke, _, index, *_ = lcps
    out = smoke.hnsw_build_parity(index.x[:512], 8, 16)
    assert out == dict(differing_rows=0, knn_rows=0, prune_rows=0)


def test_incremental_phase_runs_on_cpu_tensors(lcps, capsys):
    smoke, dev, index, wl, *_ = lcps
    tti = smoke.incremental_phase(dev, index.x, wl.xq[:8], n_inc=160,
                                  prefix=48, m=4, gamma=3, efc=8)
    assert set(tti) == set(smoke.INC_VARIANTS)
    out = capsys.readouterr().out
    for variant in smoke.INC_VARIANTS:
        assert f"variant={variant} n=160" in out
        assert (f"[parity] path=incremental variant={variant} rows=48 "
                "diverging_inserts=0") in out
    assert "tti_order_as_paper=" in out


def test_near_tie_helpers():
    smoke = _chip_smoke()
    x = np.array([[0, 0], [3, 4], [4, 3], [6, 8], [1, 1]], np.float32)
    # rows 1 and 2 are equidistant from row 0: swapping them is a tie
    assert smoke.assert_knn_near_ties(np.array([[1, 2, 3]]),
                                      np.array([[2, 1, 3]]), x, "t") == 1
    with pytest.raises(AssertionError, match="near tie"):
        smoke.assert_knn_near_ties(np.array([[1, 3, 2]]),
                                   np.array([[1, 2, 3]]), x, "t")
    pre = [np.full((5, 2), -1)]
    a = [pre[0].copy()]
    b = [pre[0].copy()]
    a[0][0] = [1, 2]
    b[0][0] = [2, 1]
    assert smoke.insert_near_tie(x, 0, pre, a, b)
    a[0][0], b[0][0] = [1, 4], [1, 3]
    assert not smoke.insert_near_tie(x, 0, pre, a, b)
    # v's lists agree, a reverse list differs: its owner's distances decide
    a[0][0] = b[0][0]
    a[0][4], b[0][4] = [1, 0], [2, 0]   # rows 1 and 2 tie from row 4
    assert smoke.insert_near_tie(x, 0, [np.where(np.arange(5)[:, None] == 4,
                                                 [[1, 2]], -1)], a, b)
    assert not smoke.insert_near_tie(x, 0, pre, a, b)
    # the margin of a prune whose decision rests on an exact tie is 0
    gap = smoke.rng_prune_margin(x, np.array([[1, 2, 3, 4]] * 5), [0], 3)
    assert gap.shape == (1,) and np.isfinite(gap).all()
