"""``chip_smoke.py``'s train phase on CPU tensors, at the REDUCED configs.

The phase's functions take any device: on the CPU they run the two-tower
``train_batch`` step on a REDUCED model (its 32-row batch drawn from the
phase's Zipf law), held to a CPU copy of the rows it touches and to that
copy's float64 run; the PNA ``molecule`` step at its REDUCED shape; a
checkpoint round trip; the launcher with a resume; and the ``pna_sparse``
part (``full_graph_sm``, the sampler and ``minibatch_lg``'s fixed-shape
batch, ``ogb_products``' parity cut and its graph) at REDUCED sizes.  No
kernel launches on the train path.  Tolerances: as the phase's own checks (loss
rtol 1e-5; gradients within 4x the CPU copy's own fp32 distance to
float64, or 1e-5 relative L2; one ``adamw_update`` from the same
gradients within rtol 1e-5 and 1e-6 of each tensor's largest magnitude).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")
CPU = torch.device("cpu")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


def _model(seed=0):
    arch = get_arch("two-tower-retrieval")
    cfg = arch.config(reduced=True)
    return arch.init(cfg, torch.Generator().manual_seed(seed), device="cpu")


def test_zipf_batch_law(smoke):
    cfg = get_arch("two-tower-retrieval").config(reduced=True)
    a = smoke.zipf_batch(cfg, 4096, seed=1)
    b = smoke.zipf_batch(cfg, 4096, seed=1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["user_feats"].shape == (4096, cfg.n_user_feats)
    assert a["item_id"].dtype == np.int32 and a["logq"].dtype == np.float32
    assert 0 <= a["user_id"].min() and a["user_id"].max() < cfg.n_users
    assert 0 <= a["item_id"].min() and a["item_id"].max() < cfg.n_items
    # logq is the drawn item's log-probability: one value per item, and
    # the most frequent item has the largest
    ids, counts = np.unique(a["item_id"], return_counts=True)
    per_item = {int(i): set(a["logq"][a["item_id"] == i]) for i in ids[:20]}
    assert all(len(v) == 1 for v in per_item.values())
    top = ids[np.argmax(counts)]
    assert a["logq"][a["item_id"] == top][0] == a["logq"].max()
    assert np.isclose(np.exp(a["logq"].max()),
                      1 / np.sum(np.arange(1, cfg.n_items + 1) ** -1.1),
                      rtol=1e-5)


def test_two_tower_train_runs_on_cpu_tensors(smoke, capsys):
    model = _model()
    rec = smoke.two_tower_train(CPU, model, model.cfg, 32, steps=2,
                                split=1, parity_rows=16)
    assert rec["batch"] == 32 and len(rec["losses"]) == 2
    assert set(rec["kernel_launches"].values()) == {0}
    assert rec["peak_memory_bytes"] is None
    assert rec["peak_above_start_bytes"] is None
    assert 0 < rec["fwd_bwd_share"] < 1
    out = capsys.readouterr().out
    assert "[train] arch=two-tower-retrieval shape=train_batch" in out
    assert "[parity] path=two-tower train_batch rows=16" in out
    assert not any(p.requires_grad for p in model.parameters())
    # the sharded step and the compressed mean of the user table's gradient
    shard, psum = rec["sharded"], rec["compressed_psum"]
    assert shard["bit_identical_tensors"] == 3 * 10 + 2
    assert set(shard["sharded_launches"].values()) == {0}
    assert psum["bit_identical_to_cpu"] and psum["shape"] == (1024, 16)
    assert 0 < psum["call1_rel_err"] < smoke.PSUM_REL_TOL
    assert "[train] path=two-tower sharded_step" in out
    assert "[train] path=two-tower user_emb gradient compressed_psum" in out


def test_pna_train_runs_on_cpu_tensors(smoke, capsys):
    rec, model, opt = smoke.pna_train(CPU, reduced=True, steps=3)
    assert rec["graphs"] == 4 and rec["layers"] == 2
    assert len(rec["losses"]) == 3 and int(opt.step) == 5   # + sharded
    assert set(rec["kernel_launches"].values()) == {0}
    assert rec["sharded"]["bit_identical_tensors"] == 3 * 6 + 2
    assert "[parity] path=pna molecule train step 1" in capsys.readouterr().out


def test_sparse_batch_law(smoke):
    batch, _, _ = smoke.sparse_batch(CPU, n=50, e=300, d_feat=4, classes=3,
                                     real_nodes=45, real_edges=280,
                                     labelled=12, seed=1)
    src, dst = batch["src"].numpy(), batch["dst"].numpy()
    assert src.dtype == dst.dtype == np.int32
    assert (dst[280:] == -1).all() and (src[280:] == 0).all()
    assert 0 <= dst[:280].min() and dst[:280].max() < 45
    assert 0 <= src[:280].min() and src[:280].max() < 45
    mask = batch["label_mask"].numpy()
    assert mask.sum() == 12 and not mask[45:].any()
    assert not batch["feats"][45:].any() and batch["feats"][:45].all()
    assert batch["labels"].max() < 3
    again, _, _ = smoke.sparse_batch(CPU, n=50, e=300, d_feat=4, classes=3,
                                     real_nodes=45, real_edges=280,
                                     labelled=12, seed=1)
    for k in batch:
        assert torch.equal(batch[k], again[k])


@pytest.mark.parametrize("part", ["full_graph_sm", "sampler", "minibatch_lg",
                                  "ogb_parity", "ogb_products"])
def test_pna_sparse_part_runs_on_cpu_tensors(smoke, capsys, part):
    run = {"full_graph_sm": lambda: smoke.sparse_cell_train(
               CPU, "full_graph_sm", reduced=True, steps=3),
           "sampler": lambda: smoke.reddit_sampler(CPU, reduced=True),
           "minibatch_lg": lambda: smoke.minibatch_cell(CPU, reduced=True,
                                                        steps=3),
           "ogb_parity": lambda: smoke.ogb_parity(CPU, reduced=True),
           "ogb_products": lambda: smoke.ogb_train(CPU, reduced=True,
                                                   steps=2)}[part]
    rec = run()
    assert set(rec["kernel_launches"].values()) == {0}
    log = capsys.readouterr().out
    if part == "full_graph_sm":
        assert (rec["n_nodes"], rec["n_edges"], len(rec["losses"])) == (
            200, 800, 3)
        assert "[parity] path=pna full_graph_sm train step 1" in log
        assert "card_fp64_vs_cpu_fp64=" in log
    elif part == "sampler":
        # hop 1: 3 per seed; hop 2: 2 per distinct hop-1 source
        e2, e1 = rec["hop_edges"]
        assert e1 == 32 * 3 and e2 % 2 == 0 and e2 <= e1 * 2
        assert rec["seed_rows"] == 32 and rec["block_nodes"] <= 32 * 10
        assert "[parity] path=pna minibatch_lg sampled block" in log
    elif part == "minibatch_lg":
        assert rec["layers"] == 4 and rec["layers_3_4_zero_grad"]
        assert rec["hop_edges"] == (48, 24) and len(rec["losses"]) == 3
    elif part == "ogb_parity":
        assert rec["n_edges"] == 400 and rec["edge_chunk"] == 100
        assert "chunks=4" in log
    else:
        assert rec["step1_vs_nograd_rel_err"] <= 1e-5
        assert rec["losses"][-1] < rec["loss_step1"]


def test_pna_sparse_phases_compose_on_cpu(smoke, capsys):
    out = smoke.pna_sparse_phases(CPU, reduced=True)
    assert set(out["kernel_launches"].values()) == {0}
    assert {"full_graph_sm", "sampler", "minibatch_lg", "ogb_parity",
            "ogb_products"} <= set(out)
    assert "[train] part=pna_sparse seconds=" in capsys.readouterr().out


def test_grad_parity_rejects_a_wrong_gradient(smoke):
    rng = np.random.default_rng(0)
    g64 = {"w": torch.from_numpy(rng.normal(size=(50, 8)))}
    cpu = {"w": g64["w"].float()}
    card = {"w": cpu["w"].clone()}
    smoke.grad_parity(card, cpu, g64, {}, "same")
    card["w"][3, 4] += 1e-3 * float(cpu["w"].norm())
    with pytest.raises(AssertionError, match="card vs CPU"):
        smoke.grad_parity(card, cpu, g64, {}, "perturbed")


def test_checkpoint_roundtrip_and_launcher_on_cpu(smoke, capsys):
    _, model, opt = smoke.pna_train(CPU, reduced=True, steps=1)
    out = smoke.checkpoint_roundtrip(CPU, model, opt)
    assert set(out) == {"sync", "async"}
    rec = smoke.launcher_run(CPU)
    assert rec["losses"][0][0] == 0 and rec["losses"][-1][0] == 29
    log = capsys.readouterr().out
    assert "bit_identical=True" in log
    assert "two-tower FULL state not written" in log


def test_train_phases_compose_on_cpu(smoke, capsys):
    res = smoke.train_phases(CPU, _model(1), reduced=True)
    assert res["two_tower"]["batch"] == 32 and res["pna"]["graphs"] == 4
    assert "[train] seconds=" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["random", "padding", "clip", "dup"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_library_matches_plain(smoke, kind, mode):
    from repro_torch.kernels.embedding_bag import embedding_bag_ref
    ids, table, _ = (torch.from_numpy(a) for a in smoke.bag_inputs(
        17, 5, 40, 8, kind=kind, seed=3))
    fn, calls = smoke.bag_library(ids, table, mode)
    torch.testing.assert_close(fn(), embedding_bag_ref(ids, table, mode),
                               rtol=1e-5, atol=1e-5)
    assert "1 call" in calls


def test_sharded_train_rejects_a_differing_step(smoke, monkeypatch):
    """A sharded step whose result differs from the plain one's in one
    parameter's last bit fails the check."""
    from repro_torch.distributed import sharding
    real = sharding.sharded_step

    def off(step, mesh, specs):
        run = real(step, mesh, specs)

        def wrapped(*args):
            model, opt, loss = run(*args)
            w = model.user_tower[0].bias
            w.data = torch.nextafter(w.data, w.data + 1)
            return model, opt, loss
        return wrapped
    monkeypatch.setattr(sharding, "sharded_step", off)
    from repro_torch.train import init_adamw
    model = _model()
    batch = {k: torch.from_numpy(v)
             for k, v in smoke.zipf_batch(model.cfg, 32, seed=2).items()}
    with pytest.raises(AssertionError, match="differs from the plain"):
        smoke.sharded_train(CPU, "two-tower-retrieval", model.cfg,
                            "train_batch", model, init_adamw(model), batch,
                            "two-tower")


def test_compressed_psum_check_on_cpu(smoke, monkeypatch):
    g = torch.randn((300, 7), generator=torch.Generator().manual_seed(2))
    g[5:40] = 0.0
    rec = smoke.compressed_psum_check(g, "x")
    assert rec["bit_identical_to_cpu"]
    assert rec["call1_rel_err"] <= 1 / 254 + 1e-6
    assert rec["call2_rel_err"] <= 1 / 254 + 1e-6
    monkeypatch.setattr(smoke, "PSUM_REL_TOL", 1e-4)
    with pytest.raises(AssertionError, match="call 1: error"):
        smoke.compressed_psum_check(g, "x")


def test_sharded_lookup_check_on_cpu(smoke):
    table = torch.randn((1000, 8), generator=torch.Generator().manual_seed(3))
    rec = smoke.sharded_lookup_check(CPU, table)
    n = np.prod(smoke.LOOKUP_SHAPE)
    assert rec["bit_identical"] and rec["ids"] == smoke.LOOKUP_SHAPE
    assert abs(rec["padding"] / n - smoke.LOOKUP_PAD) < 0.01
    assert abs(rec["over_v"] / n - smoke.LOOKUP_OVER) < 0.002
    assert set(rec["sharded_launches"].values()) == {0}
