"""``chip_smoke.py``'s ``lm`` part on CPU tensors, at the REDUCED configs,
and the training launcher on the five LM arches.

The part's functions take any device: on the CPU they run each LM arch
through every cell that runs (``train_4k``, ``prefill_32k``,
``decode_32k``; gemma3 also ``long_500k``) on REDUCED models and shapes,
with the part's own checks: step 1 of a one-period copy against a CPU
copy (logits and loss within rtol 1e-5; gradients within 4x the copy's
own fp32 distance to float64, or 1e-5 relative L2; a prefill and 3
decode steps; one ``adamw_update``), the MoE forward's bits equal on a
rerun, losses that do not rise, the cache written in place, and no
kernel launches.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")
CPU = torch.device("cpu")
LM_ARCHS = ["smollm-360m", "qwen3-8b", "gemma3-27b", "deepseek-v2-lite-16b",
            "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module")
def smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cuts_are_whole_periods_at_full_width(smoke):
    """Every FULL cell keeps every published width; only depth (all of it,
    or whole periods) and batch are cut."""
    for arch_id in LM_ARCHS:
        full = get_arch(arch_id).config()
        plan = smoke.lm_plan(arch_id, reduced=False)
        want = {c.shape for c in get_arch(arch_id).cells() if c.skip is None}
        assert set(plan) == want
        for shape, (cfg, b, s) in plan.items():
            assert dataclasses.replace(cfg, n_layers=full.n_layers) == full
            assert (cfg.n_layers == full.n_layers
                    or cfg.n_layers % smoke.lm_period(full) == 0)
            assert 0 < cfg.n_layers <= full.n_layers and b >= 1
    assert smoke.lm_period(get_arch("gemma3-27b").config()) == 6
    assert smoke.lm_plan("gemma3-27b", reduced=False)["long_500k"][2] == \
        524288


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_arch_runs_on_cpu_tensors(smoke, capsys, arch_id):
    rec = smoke.lm_arch(CPU, arch_id, reduced=True)
    cells = {"train_4k", "prefill_32k", "decode_32k"} | (
        {"long_500k"} if arch_id == "gemma3-27b" else set())
    assert set(rec) == cells | {"parity"}
    for cell in cells:
        assert set(rec[cell]["kernel_launches"].values()) == {0}
    tr = rec["train_4k"]
    assert (tr["batch"], tr["seq"]) == (4, 32)
    assert len(tr["losses"]) == smoke.LM_TRAIN_STEPS
    assert tr["peak_memory_bytes"] is None
    assert rec["decode_32k"]["cache_rows"] == 32
    par = rec["parity"]
    assert par["layers"] == (6 if arch_id == "gemma3-27b" else 1)
    assert par["gradients"]["max_rel_l2"] <= smoke.GRAD_REL_FLOOR
    assert par["bf16_vs_fp32_rel_l2"] < 5e-2
    # the update held on the CPU covers the embedding's rows of the tokens
    # and one they do not touch
    assert 1 < par["adamw_update_embed_rows"] <= 26
    moe = get_arch(arch_id).config().is_moe
    assert rec["prefill_32k"].get("moe_forward_bit_identical") == (
        True if moe else None)
    assert ("experts_read" in rec["decode_32k"]) == moe
    # the steps through sharded_step: bit-identical to the plain calls
    sh = par["sharded"]
    n_params = len(dict(get_arch(arch_id).module(
        get_arch(arch_id).config(reduced=True)).named_parameters()))
    per_layer = (n_params - 2) // get_arch(arch_id).config(
        reduced=True).n_layers
    n_period = 2 + per_layer * par["layers"]
    for layout in ("baseline", "pure_dp"):
        assert sh[f"train_{layout}"]["bit_identical_tensors"] == (
            3 * n_period + 2)
        assert set(sh[f"train_{layout}"]["launches"].values()) == {0}
    assert sh["prefill_32k"]["bit_identical_tensors"] == 3
    assert sh["decode_32k"]["bit_identical_tensors"] == 3
    log = capsys.readouterr().out
    assert f"[parity] path={arch_id} step 1 (one period, fp32)" in log
    assert f"[lm] arch={arch_id} path=sharded_step (one period, fp32)" in log


def test_lm_phases_compose_on_cpu(smoke, capsys, monkeypatch):
    monkeypatch.setattr(smoke, "LM_ARCHES", ("moonshot-v1-16b-a3b",))
    out = smoke.lm_phases(CPU, reduced=True)
    assert set(out["kernel_launches"].values()) == {0}
    assert len(out["kernel_launches"]) == 5
    assert "[lm] part=lm seconds=" in capsys.readouterr().out


@pytest.mark.parametrize("step", [0, 2])
def test_train_counts_rises_and_rejects_a_first_one(smoke, monkeypatch,
                                                    step):
    """A later step's rise is counted; a first step that does not lower
    the loss fails the cell."""
    real = smoke.counted_steps

    def rising(dev, step_fn, model, opt, batch, steps, what, check=None):
        opt, ms, losses, launches = real(dev, step_fn, model, opt, batch,
                                         steps, what, check)
        losses[step] += 1.0
        return opt, ms, losses, launches
    monkeypatch.setattr(smoke, "counted_steps", rising)
    cfg = get_arch("qwen3-8b").config(reduced=True)
    rng = np.random.default_rng(0)
    run = lambda: smoke.lm_train(CPU, "qwen3-8b", cfg, 2, 16, rng,  # noqa
                                 smoke.ZipfIds(rng, cfg.vocab))
    if step == 0:
        with pytest.raises(AssertionError, match="did not lower the loss"):
            run()
    else:
        assert run()["loss_rises"] == 1


def test_moe_forward_must_repeat_its_bits(smoke, monkeypatch):
    """A forward that changes between two runs fails the prefill cell."""
    real = tt.forward
    calls = []

    def drifting(cfg, model, tokens):
        out = real(cfg, model, tokens)
        calls.append(1)
        return out + (len(calls) - 1) * 1e-3
    monkeypatch.setattr(tt, "forward", drifting)
    cfg = get_arch("deepseek-v2-lite-16b").config(reduced=True)
    rng = np.random.default_rng(0)
    with pytest.raises(AssertionError, match="two MoE forwards differ"):
        smoke.lm_prefill(CPU, "deepseek-v2-lite-16b", cfg, 1, 16, rng,
                         smoke.ZipfIds(rng, cfg.vocab))


def test_routes_are_recorded_and_flips_counted(smoke):
    cfg = get_arch("moonshot-v1-16b-a3b").config(reduced=True)
    model = get_arch("moonshot-v1-16b-a3b").init(
        cfg, torch.Generator().manual_seed(3), device="cpu")
    routes = []
    with smoke.recorded_routes(routes):
        tt.forward(cfg, model, torch.zeros((1, 5), dtype=torch.int32))
    assert [tuple(r.shape) for r in routes] == [(5, cfg.top_k)] * 2
    assert tt.moe_route.__name__ == "moe_route"        # restored
    other = [r.flip(-1) for r in routes]                # same sets
    assert smoke.routing_flips(routes, other) == 0
    other[0] = (other[0] + 1) % cfg.n_experts
    assert smoke.routing_flips(routes, other) == 5


def test_grad_rule_needs_float64_only_beyond_the_floor(smoke):
    """``grad_parity`` without a float64 run holds to the floor alone;
    beyond it the CPU's own distance to float64 decides, and a gradient
    1e-3 off a copy that stands near float64 fails."""
    g = torch.Generator().manual_seed(4)
    card = {"w": torch.randn((300, 7), generator=g),
            "b": torch.randn(5, generator=g)}
    rec = smoke.grad_parity(card, card, None, {}, "x")
    assert rec["max_rel_l2"] == 0.0 and rec["cpu_fp32_vs_fp64"] is None
    off = dict(card, w=card["w"] * (1 + 1e-3))
    with pytest.raises(AssertionError, match="gradient w"):
        smoke.grad_parity(off, card, None, {}, "x")
    rec = smoke.grad_parity(off, card, None, {}, "x", floor=2e-3)
    assert rec["worst_param"] == "w" and rec["cpu_fp32_vs_fp64"] is None
    assert rec["worst_rel_l2"] == pytest.approx(1e-3, rel=1e-3)
    g64 = {k: v.double() for k, v in card.items()}
    with pytest.raises(AssertionError, match="gradient w"):
        smoke.grad_parity(off, card, g64, {}, "x")
    noisy = {k: v * (1 + 1e-3) for k, v in g64.items()}   # the CPU 1e-3 off
    rec = smoke.grad_parity(off, card, noisy, {}, "x")
    assert rec["cpu_fp32_vs_fp64"] == pytest.approx(1e-3, rel=1e-2)


@pytest.mark.parametrize("arch_id", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_lm_parity_float64_run(smoke, monkeypatch, capsys, arch_id):
    """A gradient beyond the floor (here made to stand so) sends
    ``lm_parity`` to its float64 run, whose distances then decide; the
    model it rebuilds still takes the update check."""
    real = smoke.grad_parity

    def beyond_floor(card, cpu, cpu64, rows, what):
        if cpu64 is None:
            raise AssertionError(f"{what} gradient: beyond the floor")
        return real(card, cpu, cpu64, rows, what)
    monkeypatch.setattr(smoke, "grad_parity", beyond_floor)
    cfg = get_arch(arch_id).config(reduced=True)
    rec = smoke.lm_parity(CPU, arch_id, cfg, 24)
    assert rec["gradients"]["cpu_fp32_vs_fp64"] > 0.0
    assert rec["gradients"]["max_rel_l2"] == 0.0        # one device here
    assert rec["adamw_update_max_abs_err"] < 1e-6     # another sum order


def test_bf16_step_check_catches_a_bf16_fault(smoke, monkeypatch):
    """An update that goes wrong on bf16 parameters only (here: against
    the gradient) fails ``lm_parity``'s bf16-step check."""
    real = optimizer._adamw_elements

    def against(cfg, p, m, v, grad, scale, lr, c1, c2):
        if p.dtype == torch.bfloat16:
            grad = -grad
        real(cfg, p, m, v, grad, scale, lr, c1, c2)
    monkeypatch.setattr(optimizer, "_adamw_elements", against)
    with pytest.raises(AssertionError, match="bf16 train step differs"):
        smoke.lm_parity(CPU, "qwen3-8b",
                        get_arch("qwen3-8b").config(reduced=True), 24)


def test_grad_parity_walks_chunks(smoke, monkeypatch):
    """The distances summed ``NORM_CHUNK`` elements at a time equal one
    pass's, rows of a table picked on the card's side."""
    g = torch.Generator().manual_seed(7)
    card = {"t": torch.randn((50, 3), generator=g)}
    rows = {"t": torch.tensor([1, 4, 9])}
    cpu = {"t": card["t"][rows["t"]] * (1 + 1e-3)}
    g64 = {"t": card["t"][rows["t"]].double()}
    whole = smoke.grad_parity(card, cpu, g64, rows, "x", floor=1.0)
    monkeypatch.setattr(optimizer, "NORM_CHUNK", 2)
    parts = smoke.grad_parity(card, cpu, g64, rows, "x", floor=1.0)
    for k in ("worst_rel_l2", "cpu_fp32_vs_fp64", "max_abs_err"):
        assert parts[k] == pytest.approx(whole[k], rel=1e-12)
    assert whole["worst_rel_l2"] == pytest.approx(1e-3, rel=1e-3)


def test_update_parity_holds_the_cpu_subset(smoke):
    from repro_torch.train import adamw_update, init_adamw
    from repro_torch.train.optimizer import AdamWConfig
    g = torch.Generator().manual_seed(6)
    params = {"a": torch.randn((4, 3), generator=g),
              "b": torch.randn(6, generator=g)}
    grads = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
    card = {k: v.clone() for k, v in params.items()}
    cpu = {"b": params["b"].clone()}
    cfg = AdamWConfig(warmup_steps=1)
    _, st = adamw_update(cfg, grads, init_adamw(card), card)
    _, cst = adamw_update(cfg, grads, init_adamw(cpu), cpu)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in card.items():
                self.register_parameter(k, torch.nn.Parameter(v))
    assert smoke.update_parity(Model(), st, cpu, cst, {}, "x",
                               keys=["b"]) == 0.0
    with pytest.raises(AssertionError, match="param holds"):
        smoke.update_parity(Model(), st, cpu, cst, {}, "x")   # all of them
    with pytest.raises(AssertionError, match="param holds"):
        smoke.update_parity(Model(), st, {}, cst, {}, "x", keys=[])
    cst.mu["b"][0] += 1.0
    with pytest.raises(AssertionError, match="mu b"):
        smoke.update_parity(Model(), st, cpu, cst, {}, "x", keys=["b"])


def test_adamw_in_chunks_equals_whole(monkeypatch):
    """``adamw_update`` walks a contiguous parameter ``NORM_CHUNK``
    elements at a time: the same bits as one pass (a non-contiguous one
    goes whole)."""
    g = torch.Generator().manual_seed(5)
    params = {"a": torch.randn((37, 11), generator=g),
              "b": torch.randn((5, 9), generator=g).to(torch.bfloat16),
              "t": torch.randn((6, 4), generator=g).T}
    grads = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
    runs = []
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(optimizer, "NORM_CHUNK", chunk)
        p = {k: v.clone() if k != "t" else v.clone().T.contiguous().T
             for k, v in params.items()}
        st = optimizer.init_adamw(p)
        for _ in range(2):
            _, st = optimizer.adamw_update(optimizer.AdamWConfig(lr=1e-2,
                                                                 warmup_steps=1),
                                           grads, st, p)
        runs.append((p, st))
    (p1, s1), (p2, s2) = runs
    for k in params:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1.mu[k], s2.mu[k])
        assert torch.equal(s1.nu[k], s2.nu[k])
        assert not torch.equal(p1[k], params[k])


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_launcher_trains_lm_arch_and_resumes(arch_id, tmp_path, capsys):
    argv = ["--arch", arch_id, "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2"]
    first = launch.main(argv + ["--steps", "4"])
    resumed = launch.main(argv + ["--steps", "6"])
    assert first["steps"] == 4 and resumed["steps"] == 2
    assert first["shape"] == "train_4k"
    losses = [v for _, v in first["losses"] + resumed["losses"]]
    assert np.isfinite(losses).all()
    assert f"{arch_id}/train_4k: 4 steps" in capsys.readouterr().out
    assert all(bool(torch.isfinite(p).all())
               for p in resumed["params"].parameters())


def test_bits_digest_sees_one_element(smoke, monkeypatch):
    """The digest of equal bits is equal (in chunks or whole); one element
    one ulp off, or two elements swapped, changes it."""
    t = torch.randn(1000, generator=torch.Generator().manual_seed(8))
    d = smoke.bits_digest(t)
    assert torch.equal(d, smoke.bits_digest(t.clone()))
    monkeypatch.setattr(optimizer, "NORM_CHUNK", 64)
    assert torch.equal(d, smoke.bits_digest(t))
    off = t.clone()
    off[517] = torch.nextafter(off[517], torch.tensor(2.0))
    assert not torch.equal(d, smoke.bits_digest(off))
    swapped = t.clone()
    swapped[[3, 900]] = t[[900, 3]]
    dd = smoke.bits_digest(swapped)
    assert dd[0] == d[0] and not torch.equal(dd, d)
    assert torch.equal(smoke.bits_digest(torch.tensor(-0.0)),
                       smoke.bits_digest(torch.tensor(-0.0)))
    assert not torch.equal(smoke.bits_digest(torch.tensor(-0.0)),
                           smoke.bits_digest(torch.tensor(0.0)))
    with pytest.raises(ValueError, match="4-byte"):
        smoke.bits_digest(t.double())


def test_lm_sharded_rejects_a_differing_step(smoke, monkeypatch):
    """A sharded train step whose loss is one ulp off fails the check."""
    from repro_torch.distributed import sharding
    real = sharding.sharded_step

    def off(step, mesh, specs):
        run = real(step, mesh, specs)

        def wrapped(*args):
            outs = run(*args)
            if len(outs) == 3:
                outs = (outs[0], outs[1],
                        torch.nextafter(outs[2], outs[2] + 1))
            return outs
        return wrapped
    monkeypatch.setattr(sharding, "sharded_step", off)
    cfg = get_arch("qwen3-8b").config(reduced=True)
    c16 = dataclasses.replace(cfg, n_layers=1, dtype=torch.bfloat16)
    c32 = dataclasses.replace(c16, dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab, (1, 9), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2))
    with pytest.raises(AssertionError, match="differs from the plain"):
        smoke.lm_sharded(CPU, "qwen3-8b", c16, c32,
                         {"tokens": tok[:, :-1], "labels": tok[:, 1:]})


def test_split_kv_check_on_cpu(smoke):
    rec = smoke.split_kv_check(CPU, *smoke.SPLIT_KV_REDUCED)
    assert rec["empty_row_zero"] and rec["max_abs_err"] < 1e-6
    assert rec["kv"] == smoke.SPLIT_KV_REDUCED[0]
    assert set(rec["sharded_launches"].values()) == {0}
    assert rec["bytes_read"] > 2 * 2 * np.prod(rec["kv"])
