"""The PyTorch port's bulk builder against the JAX reference.

``build_bulk`` for acorn-gamma and acorn-1 at n = 1500, d = 16, given the
reference's levels: neighbour lists must be identical to the reference
builder's, except where the exact KNN meets a near tie in distance.  The
test checks that any difference is so explained: the two packages' KNN
lists may differ only at near ties, and the port's compression and
reverse-slack passes applied to the reference's own KNN lists must give
the reference's graph exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.core.graph import assign_levels as jax_levels
from repro.data import make_lcps_dataset
from repro_torch.core import build as tbuild
from repro_torch.core.graph import assign_levels, level_constant
from torch_parity import NEAR_TIE_REL

N, D, SEED, M, GAMMA, M_BETA = 1500, 16, 0, 8, 8, 16


@pytest.fixture(scope="module")
def data():
    ds = make_lcps_dataset(n=N, d=D, card=8, seed=SEED)
    return np.asarray(ds.x)


def _assert_knn_near_ties(knn_port, knn_ref, x, members):
    """Rows may differ only where two candidates sit at a near tie."""
    xm = x[members].astype(np.float64)
    for r in np.nonzero((knn_port != knn_ref).any(axis=1))[0]:
        for a, b in zip(knn_port[r], knn_ref[r]):
            if a == b:
                continue
            da = ((xm[a] - xm[r]) ** 2).sum()
            db = ((xm[b] - xm[r]) ** 2).sum()
            assert abs(da - db) <= NEAR_TIE_REL * max(da, db), (r, a, b)


@pytest.mark.parametrize("variant", ["acorn-gamma", "acorn-1"])
def test_build_bulk_matches_reference(data, variant):
    kw = dict(gamma=GAMMA, m_beta=M_BETA) if variant == "acorn-gamma" else {}
    jg = jbuild.build_bulk(data, jax.random.PRNGKey(SEED), M,
                           variant=variant, **kw)
    levels = np.asarray(jg.levels)
    tg = tbuild.build_bulk(torch.from_numpy(data.copy()), None, M,
                           variant=variant, levels=levels, **kw)
    assert tg.num_levels == jg.num_levels
    assert int(tg.entry_point) == int(jg.entry_point)
    for lvl in range(jg.num_levels):
        assert np.array_equal(tg.pos[lvl].numpy(), np.asarray(jg.pos[lvl]))
        assert np.array_equal(tg.node_ids[lvl].numpy(),
                              np.asarray(jg.node_ids[lvl]))
        want = np.asarray(jg.neighbors[lvl])
        got = tg.neighbors[lvl].numpy()
        assert got.shape == want.shape
        if np.array_equal(got, want):
            continue
        # a difference must trace back to an exact-KNN near tie
        members = np.nonzero(levels >= lvl)[0]
        gamma = GAMMA if variant == "acorn-gamma" else 1
        k_cand = min(M * gamma, max(len(members) - 1, 1))
        xm = data[members]
        knn_ref = np.asarray(jbuild.knn_among(xm, k_cand))
        knn_port = tbuild.knn_among(torch.from_numpy(xm.copy()),
                                    k_cand).numpy()
        _assert_knn_near_ties(knn_port, knn_ref, data, members)


def test_compress_and_slack_match_reference(data):
    """On the reference's own KNN lists, the port's compression and
    reverse-slack passes reproduce the reference exactly."""
    k = M * GAMMA
    knn = np.asarray(jbuild.knn_among(data, k))
    cap0 = min(M * GAMMA, M_BETA + 2 * M)
    want = np.asarray(jbuild.with_reverse_slack(
        jbuild.acorn_compress(knn, M_BETA, cap_total=k, cap_out=cap0,
                              t_hop=M_BETA), 4))
    got = tbuild.with_reverse_slack(
        tbuild.acorn_compress(torch.from_numpy(knn.copy()), M_BETA,
                              cap_out=cap0, t_hop=M_BETA, block=97), 4)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_reverse_slack_matches_reference(seed):
    rng = np.random.default_rng(seed)
    fwd = rng.integers(-1, 50, size=(50, 6)).astype(np.int32)
    want = jbuild.reverse_slack(fwd, 3)
    got = tbuild.reverse_slack(torch.from_numpy(fwd), 3).numpy()
    assert np.array_equal(got, want)


def test_knn_among_matches_reference(data):
    want = np.asarray(jbuild.knn_among(data[:600], 20))
    got = tbuild.knn_among(torch.from_numpy(data[:600].copy()), 20,
                           qblock=128).numpy()
    _assert_knn_near_ties(got, want, data[:600], np.arange(600))


def test_assign_levels_law_and_given_levels():
    gen = torch.Generator().manual_seed(0)
    lv = assign_levels(gen, 200_000, 16).numpy()
    mL = level_constant(16)
    # P(level >= 1) = exp(-1 / mL) for the exponential draw
    assert abs((lv >= 1).mean() - np.exp(-1 / mL)) < 0.005
    assert lv.min() == 0 and lv.max() <= int(np.log(200_000) / np.log(16)) + 1
    given = np.asarray(jax_levels(jax.random.PRNGKey(1), 100, 16))
    assert np.array_equal(assign_levels(None, 100, 16, levels=given).numpy(),
                          given)
