"""The PyTorch port's synthetic data against the JAX reference.

``make_hcps_dataset`` must make every array of the reference's at the same
seed (vectors, dates, keyword bits, captions, cluster assignment, centres
and cluster keywords), and ``make_workload`` the same queries and
predicates for every kind and correlation.  Both are seeded through numpy
with the reference's call order.  Tolerance: none — arrays equal, and
predicates equal field by field (their ``repr``).
"""
import numpy as np
import pytest

import repro.data as JD
import repro_torch.data as TD

KINDS = ["contains", "between", "contains+between", "regex"]
CORRELATIONS = ["none", "pos", "neg"]


@pytest.fixture(scope="module", params=[0, 7], ids=lambda s: f"seed{s}")
def datasets(request):
    seed = request.param
    return (seed, JD.make_hcps_dataset(n=1500, d=8, seed=seed),
            TD.make_hcps_dataset(n=1500, d=8, seed=seed, device="cpu"))


def test_hcps_arrays_equal(datasets):
    _, j, t = datasets
    assert np.array_equal(t.x.numpy(), np.asarray(j.x))
    assert np.array_equal(t.table.int_cols["date"].numpy(),
                          np.asarray(j.table.int_cols["date"]))
    bits = t.table.bitset_cols["keywords"].numpy().view(np.uint32)
    assert np.array_equal(bits, np.asarray(j.table.bitset_cols["keywords"]))
    assert list(t.table.str_cols["caption"]) == list(
        j.table.str_cols["caption"])
    assert np.array_equal(t.cluster_of, j.cluster_of)
    assert np.array_equal(t.centers, j.centers)
    assert np.array_equal(t.cluster_keywords, j.cluster_keywords)
    assert t.table.n_keywords == j.table.n_keywords
    assert t.name == j.name


def test_hcps_generator_options_match():
    j = JD.make_hcps_dataset(n=600, d=5, n_clusters=7, kw_per_cluster=2,
                             n_keywords=20, date_range=30, seed=4,
                             center_scale=0.5, noise_kw_prob=0.9)
    t = TD.make_hcps_dataset(n=600, d=5, n_clusters=7, kw_per_cluster=2,
                             n_keywords=20, date_range=30, seed=4,
                             center_scale=0.5, noise_kw_prob=0.9,
                             device="cpu")
    assert np.array_equal(t.x.numpy(), np.asarray(j.x))
    assert np.array_equal(t.table.bitset_cols["keywords"].numpy()
                          .view(np.uint32),
                          np.asarray(j.table.bitset_cols["keywords"]))
    assert list(t.table.str_cols["caption"]) == list(
        j.table.str_cols["caption"])
    assert np.array_equal(t.table.int_cols["date"].numpy(),
                          np.asarray(j.table.int_cols["date"]))


@pytest.mark.parametrize("correlation", CORRELATIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_workload_equal(datasets, kind, correlation):
    seed, j, t = datasets
    jw = JD.make_workload(j, kind=kind, correlation=correlation,
                          n_queries=40, seed=seed + 1)
    tw = TD.make_workload(t, kind=kind, correlation=correlation,
                          n_queries=40, seed=seed + 1)
    assert np.array_equal(tw.xq.numpy(), np.asarray(jw.xq))
    assert [repr(p) for p in tw.predicates] == [repr(p)
                                               for p in jw.predicates]
    assert tw.name == jw.name and tw.k == jw.k
    assert np.array_equal(tw.masks(t).numpy(), np.asarray(jw.masks(j)))


def test_far_cluster_matches(datasets):
    from repro.data.synthetic import _far_cluster as jfar
    from repro_torch.data.synthetic import _far_cluster as tfar
    _, j, _ = datasets
    for c in range(0, len(j.centers), 3):
        assert tfar(j.centers, c) == jfar(j.centers, c)


def test_keyword_names_copied():
    from repro.data.synthetic import KEYWORD_NAMES
    assert TD.KEYWORD_NAMES == KEYWORD_NAMES


def test_kinds_need_an_hcps_dataset():
    lcps = TD.make_lcps_dataset(n=200, d=4, device="cpu")
    with pytest.raises(ValueError, match="HCPS"):
        TD.make_workload(lcps, kind="contains")
    with pytest.raises(ValueError):
        TD.make_workload(lcps, kind="nope")
    # 'between' reads only the date column of an HCPS table
    hcps = TD.make_hcps_dataset(n=300, d=4, device="cpu")
    assert len(TD.make_workload(hcps, kind="between",
                                n_queries=3).predicates) == 3
