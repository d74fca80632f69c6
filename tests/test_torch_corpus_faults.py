"""The port's corpus-sharded SPMD serving on 8 ``gloo`` ranks against the
JAX reference, continued from ``test_torch_corpus_parallel.py`` (which
holds the in-process tests and the 1 x 8 / 8 x 1 meshes): the 2 x 4 and
4 x 2 meshes, the auto mesh, mirrored failover, rebuild, hard loss and
every shard down, and the runtime's SPMD twin
(``tests/test_serving_runtime.py``).  Tolerances as there: none between
ranks and between the SPMD path and the host loop; against the
reference, ids identical except at near ties.

The ranks import this module, so it imports nothing of JAX at module
level.
"""
import numpy as np
import pytest

from test_torch_corpus_parallel import (_engine_rank, _runtime_rank,
                                        check_meshes, held, lcps_workload,
                                        reference)
from torch_parity import (assert_ids_match, assert_ranks_equal,
                          one_thread, run_ranks)  # noqa: F401  (fixture)

MESHES = [(2, 4), (4, 2)]


@pytest.fixture(scope="module")
def reference_2_4(one_thread):
    return reference((2, 4), faults=True)


def test_corpus_sharded_spmd_parity_and_faults_8_ranks(reference_2_4,
                                                        tmp_path):
    arrays, answers, gt, recall_at_k = reference_2_4
    got = run_ranks(_engine_rank, 8, tmp_path, arrays, MESHES, True)
    assert_ranks_equal(got)
    out = got[0]
    check_meshes(out, MESHES, answers, gt, recall_at_k)
    ds, wl = lcps_workload()
    assert out["auto"]["mesh"] == (4, 2)
    held(out["auto"], answers[2], ds, wl, "auto mesh")
    drill = out["mirrored"]
    held(drill["healthy"], answers[4], ds, wl, "mirrored healthy")
    held(drill["failed"], answers["mirrored"], ds, wl, "mirrored 0 down")
    np.testing.assert_array_equal(drill["failed"]["ids"],
                                  drill["healthy"]["ids"])
    assert drill["dup0"] == 0 < drill["dup1"] == drill["dup2"]
    # shard 0 rebuilt by the port's own builder: held to its host loop
    held(drill["rebuilt"], None, ds, wl, "rebuilt")
    assert not any(drill["rebuilt"]["degraded"])
    assert float(recall_at_k(drill["rebuilt"]["ids"], gt)) > 0.9
    loss = out["loss"]
    held(loss["healthy"], answers[4], ds, wl, "unmirrored healthy")
    held(loss["lost1"], answers["lost1"], ds, wl, "shard 1 lost")
    lo, hi = loss["bounds"]
    ids = loss["lost1"]["ids"]
    assert not ((ids >= lo) & (ids < hi)).any()
    assert all(loss["lost1"]["degraded"])
    held(loss["down"], None, ds, wl, "all down")
    assert (loss["down"]["ids"] == -1).all()
    assert np.isinf(loss["down"]["d"]).all()
    assert loss["dup"] == 0


def test_runtime_spmd_twin_and_rebuild_8_ranks(reference_2_4, tmp_path):
    """The runtime over a (2, 2) mesh of 8 ranks (ranks 4-7 outside it)
    equals its host-loop twin, dispatch for dispatch, and the reference's
    ids; the port-built engine's rebuilt shards return the healthy ids."""
    arrays, answers, _, _ = reference_2_4
    got = run_ranks(_runtime_rank, 8, tmp_path, arrays[2])
    assert_ranks_equal(got)
    out = got[0]
    s, h = out["spmd"], out["host"]
    assert s["mesh"] == (2, 2) and h["mesh"] is None
    np.testing.assert_array_equal(s["ids"], h["ids"])
    np.testing.assert_array_equal(s["d"], h["d"])
    assert s["log"] == h["log"]
    assert s["traces"] == {16: 1} and h["traces"] == {}
    ds, wl = lcps_workload()
    want = answers[2]
    assert_ids_match(s["ids"], np.asarray(want.ids)[:24], s["d"],
                     np.asarray(want.dists)[:24], ds.x[:], wl.xq[:24],
                     expanded=True)
    drill = out["drill"]
    for name in ("healthy", "failed", "rebuilt", "down", "all_rebuilt"):
        held(drill[name], None, ds, wl, name)
    for name in ("failed", "rebuilt", "all_rebuilt"):
        np.testing.assert_array_equal(drill[name]["ids"],
                                      drill["healthy"]["ids"], err_msg=name)
    assert (drill["down"]["ids"] == -1).all()
