"""``chip_smoke.py``'s ``recsys`` part on CPU tensors, at the REDUCED
configs.

The part's functions take any device: on the CPU they run DIEN, SASRec
and DCN-v2 through every cell (``train_batch``, ``serve_p99``,
``serve_bulk``, ``retrieval_cand``) on REDUCED models and shapes, with the
part's own checks: step 1 against CPU copies of the rows it touches, on
the card's ReLU branch (loss rtol 1e-5; gradients within 4x the copy's
own fp32 distance to float64, or 1e-5 relative L2; one ``adamw_update``
within rtol 1e-5), the blocked
losses against their plain versions, losses that do not rise, serve rows
and candidate scores against a CPU copy (rtol 1e-5, atol 1e-6), DCN-v2's
two retrieval variants agreeing, and no kernel launches.  The traffic
laws are checked on their own.
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


@pytest.fixture(scope="module")
def smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_traffic_laws(smoke):
    cfg = get_arch("dien").config(reduced=True)
    a = smoke.recsys_traffic("dien", cfg, seed=3)(512, "train")
    b = smoke.recsys_traffic("dien", cfg, seed=3)(512, "train")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    m = a["mask"] > 0
    lens = m.sum(1)
    assert lens.min() >= 1 and lens.max() <= cfg.seq_len
    assert (m == (np.arange(cfg.seq_len)[None] < lens[:, None])).all()
    assert (a["hist_items"][~m] == -1).all() and (a["hist_cates"][~m] == -1
                                                  ).all()
    assert a["hist_items"][m].max() < cfg.n_items
    # one category per item
    pairs = set(zip(a["hist_items"][m].tolist(), a["hist_cates"][m].tolist()))
    assert len({i for i, _ in pairs}) == len(pairs)
    ids, counts = np.unique(a["hist_items"][m], return_counts=True)
    assert counts.max() > 20 * np.median(counts)        # Zipf, not uniform
    assert set(np.unique(a["label"])) <= {0.0, 1.0}

    cfg = get_arch("sasrec").config(reduced=True)
    t = smoke.recsys_traffic("sasrec", cfg, seed=4)(256, "train")
    real = t["seq"] >= 0
    lens = real.sum(1)
    assert lens.min() >= 2 and lens.max() <= cfg.seq_len
    assert (real == (np.arange(cfg.seq_len)[None]
                     >= (cfg.seq_len - lens)[:, None])).all()
    assert ((t["pos"] >= 0) == real).all()
    # pos is the next item: seq shifted by one where both are real
    np.testing.assert_array_equal(t["pos"][:, :-1][real[:, :-1]],
                                  t["seq"][:, 1:][real[:, :-1]])
    assert t["neg"].shape == (256, cfg.seq_len, 64)
    assert 0 <= t["neg"].min() and t["neg"].max() < cfg.n_items
    r = smoke.recsys_traffic("dien", get_arch("dien").config(reduced=True),
                             seed=3)(1, "retrieval", 64)
    assert (r["mask"] == 1).all() and (r["hist_items"] >= 0).all()

    s = smoke.recsys_traffic("sasrec", cfg, seed=4)(8, "retrieval",
                                                    cfg.n_items)
    assert sorted(s["cand_ids"].tolist()) == list(range(cfg.n_items))

    cfg = get_arch("dcn-v2").config(reduced=True)
    d = smoke.recsys_traffic("dcn-v2", cfg, seed=5)(2048, "train")
    assert d["dense"].shape == (2048, cfg.n_dense) and d["dense"].min() >= 0
    assert (d["sparse"].max(0) < np.array(cfg.vocab_sizes)).all()
    assert abs(d["label"].mean() - 0.25) < 0.05


@pytest.mark.parametrize("arch_id", ["dien", "sasrec", "dcn-v2",
                                     "two-tower-retrieval"])
def test_copy_holds_the_touched_rows(smoke, arch_id):
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    draw = (smoke.zipf_batch(cfg, 16, 6) if arch_id == "two-tower-retrieval"
            else smoke.recsys_traffic(arch_id, cfg, seed=6)(16, "train"))
    batch = {k: torch.from_numpy(v) for k, v in draw.items()}
    copy, cpu_batch, rows = smoke.recsys_copy(arch_id, model, batch,
                                              torch.float64)
    loss_fn = arch.loss_fn(cfg, "train_batch")
    with torch.no_grad():
        want = float(loss_fn(model, batch))
        got = float(arch.loss_fn(copy.cfg, "train_batch")(copy, cpu_batch))
    assert abs(got - want) <= 1e-5 * abs(want)
    for k, r in rows.items():
        assert copy.get_parameter(k).shape[0] == len(r)
        assert torch.equal(copy.get_parameter(k).float(),
                           model.get_parameter(k)[r])


@pytest.mark.parametrize("arch_id", ["dien", "sasrec", "dcn-v2"])
def test_recsys_arch_runs_on_cpu_tensors(smoke, capsys, arch_id):
    rec = smoke.recsys_arch(CPU, arch_id, reduced=True)
    assert set(rec) >= {"train_batch", "serve_p99", "serve_bulk",
                        "retrieval_cand"}
    for cell in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
        assert set(rec[cell]["kernel_launches"].values()) == {0}
    tr = rec["train_batch"]
    assert tr["batch"] == 32 and len(tr["losses"]) == smoke.RECSYS_STEPS
    assert tr["peak_memory_bytes"] is None
    assert rec["serve_bulk"]["batch"] == 64
    assert rec["retrieval_cand"]["n_candidates"] == 256
    log = capsys.readouterr().out
    assert f"[parity] path={arch_id} train_batch step 1" in log
    if arch_id != "dcn-v2":
        assert "blocked_vs_plain_loss_err=" in log
    else:
        assert "retrieve_vs_opt_max_abs_err" in log
        assert "retrieve_opt" in rec["retrieval_cand"]
    if arch_id == "dien":
        assert rec["retrieval_cand"]["gemm_bound_ms"] > 0
        # the retrieval user's full history: every step of the AUGRU runs
        assert rec["retrieval_cand"]["valid_steps"] == get_arch(
            "dien").config(reduced=True).seq_len


def test_recsys_phases_compose_on_cpu(smoke, capsys, monkeypatch):
    monkeypatch.setattr(smoke, "RECSYS_ARCHES", ("dcn-v2",))
    out = smoke.recsys_phases(CPU, reduced=True)
    assert set(out["kernel_launches"].values()) == {0}
    assert len(out["kernel_launches"]) == 5
    assert "[train] part=recsys seconds=" in capsys.readouterr().out


def test_train_rejects_a_rising_loss(smoke, monkeypatch):
    """A step that raises the loss fails the part."""
    real = smoke.counted_steps

    def rising(dev, step, model, opt, batch, steps, what, check=None):
        opt, ms, losses, launches = real(dev, step, model, opt, batch,
                                         steps, what, check)
        return opt, ms, losses[:-1] + [losses[-1] + 1.0], launches
    monkeypatch.setattr(smoke, "counted_steps", rising)
    arch = get_arch("dcn-v2")
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(2), device="cpu")
    with pytest.raises(AssertionError, match="losses rose"):
        smoke.recsys_train(CPU, "dcn-v2", model,
                           smoke.recsys_traffic("dcn-v2", cfg), 32,
                           parity_rows=16)


def test_relu_branch_takes_the_cards_branch(smoke):
    """Replayed, a ReLU call passes its input where the recorded input was
    > 0 and 0 elsewhere, the gradient likewise, whatever its own sign."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((6, 5), generator=g, dtype=torch.float64)
    w = torch.randn((5, 4), generator=g, dtype=torch.float64)
    card = []
    with smoke.relu_branch(seen=card):
        torch.relu(x @ w)
    assert len(card) == 1 and torch.equal(card[0], x @ w)
    card[0][0, 0] = -card[0][0, 0]            # one unit on the other side
    xx = x.clone().requires_grad_()
    seen = []
    with smoke.relu_branch(card=card, seen=seen):
        out = torch.nn.functional.relu(xx @ w)
    z = x @ w
    want = torch.where(card[0] > 0, z, 0.0)
    assert torch.equal(out, want) and torch.equal(seen[0], z)
    (gx,) = torch.autograd.grad(out.sum(), xx)
    torch.testing.assert_close(gx, (card[0] > 0).double() @ w.T)
    with pytest.raises(AssertionError, match="input"):
        with smoke.relu_branch(card=card):
            torch.relu(x)


def test_step1_parity_rejects_a_branch_far_from_zero(smoke, monkeypatch):
    """A ReLU unit the card puts on the other side of a large input fails
    the step even though the CPU copies follow the card's branch."""
    from repro_torch.train import init_adamw
    real = smoke.relu_branch
    arch = get_arch("dcn-v2")
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(4), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             smoke.recsys_traffic("dcn-v2", cfg, seed=7)(16, "train").items()}
    _, rec = smoke.step1_parity(CPU, "dcn-v2", model, init_adamw(model),
                                  batch, "dcn-v2")
    assert rec["relu_flips"] == 0 and rec["gradients"]["max_rel_l2"] <= 1e-5

    class FirstFlipped(list):
        """The card's record, its first call's largest input negated."""

        def __init__(self, into):
            super().__init__()
            self.into = into

        def append(self, z):
            if not self.into:
                i = int(z.abs().argmax())
                z.view(-1)[i] = -z.view(-1)[i]
            self.into.append(z)

    def card_flips(card=None, seen=None):
        if card is None and seen is not None:     # the card's run
            return real(None, FirstFlipped(seen))
        return real(card, seen)
    monkeypatch.setattr(smoke, "relu_branch", card_flips)
    with pytest.raises(AssertionError, match="another branch"):
        smoke.step1_parity(CPU, "dcn-v2", model, init_adamw(model), batch,
                           "dcn-v2")
