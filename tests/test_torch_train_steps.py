"""The train steps of two-tower and PNA and the training launcher (every
recsys arch) against the JAX reference: twins of
``test_recsys_train_step`` (two-tower) and ``test_pna_shapes`` (every PNA
cell) of ``tests/test_models_smoke.py``;
the reference's parameters and AdamW state carried across
(``convert.adamw_state_from_arrays``), so a port step continues a
reference step; PNA's ``loss_dense`` (the plain aggregator, as the
reference trains) and its gradients; the launcher's data and first
losses.

Tolerances: losses within rtol 1e-5 (fp32); gradients within rtol 1e-4
and atol 1e-6, the atol times the gradient's largest magnitude where that
exceeds 1 (``torch_parity.assert_grad_close``); parameters and moments
after one ``adamw_update`` from the reference's own gradients within rtol
1e-6 and an atol of 1e-6 times the tensor's largest magnitude (a moment
that nearly cancels its earlier value keeps only absolute accuracy); the
launcher's first losses, each after steps whose gradients each package
computes itself, within rtol 1e-4 (two-tower) and 1e-5 (PNA
``full_graph_sm``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch import train as jlaunch
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.convert import param_arrays
from repro_torch.launch import train as launch
from repro_torch.models.gnn import loss_dense
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import (AdamWState, adamw_update,
                                         init_adamw)
from torch_parity import (assert_grad_close, molecule_graphs,
                          port_adamw_state, port_pna, port_recsys,
                          port_two_tower)

KEY = jax.random.PRNGKey(0)


def _finite(model) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in model.parameters())


def _materialize(batch_specs, seed, int_hi):
    """Random tensors for a batch of ``TensorSpec``: integers in
    [0, int_hi), adjacencies 0/1 at 0.3, the rest normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in batch_specs.items():
        if not spec.dtype.is_floating_point:
            a = rng.integers(0, int_hi, spec.shape)
        elif "adj" in name:
            a = rng.random(spec.shape) < 0.3
        else:
            a = rng.normal(size=spec.shape)
        out[name] = torch.as_tensor(np.asarray(a)).to(spec.dtype)
    return out


# ---------------------------------------------------------------------------
# two-tower train_batch
# ---------------------------------------------------------------------------


def test_recsys_train_step():
    arch = get_arch("two-tower-retrieval")
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_adamw(model)
    pspecs, ospecs, batch_s = arch.abstract_inputs(cfg, "train_batch",
                                                   reduced=True)
    assert isinstance(ospecs, AdamWState) and ospecs.mu.keys() == pspecs.keys()
    assert batch_s["user_id"].shape == (32,)
    batch = _materialize(batch_s, seed=0, int_hi=4)
    before = {k: p.clone() for k, p in model.named_parameters()}
    step = arch.step_fn(cfg, "train_batch")
    model2, opt2, loss = step(model, opt, batch)
    assert model2 is model and np.isfinite(float(loss))
    assert _finite(model) and int(opt2.step) == 1
    assert any(not torch.equal(p, before[k])
               for k, p in model.named_parameters())
    assert not any(p.requires_grad for p in model.parameters())


def _tt_batches(cfg, b, n, seed):
    """n numpy-seeded two-tower batches, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bt = {"user_id": rng.integers(0, cfg.n_users, size=b),
              "user_feats": rng.integers(0, cfg.n_users,
                                         size=(b, cfg.n_user_feats)),
              "item_id": rng.integers(0, cfg.n_items, size=b),
              "logq": rng.normal(size=b) - 3.0}
        bt = {k: v.astype(np.float32 if k == "logq" else np.int32)
              for k, v in bt.items()}
        out.append(({k: jnp.asarray(v) for k, v in bt.items()},
                    {k: torch.from_numpy(v) for k, v in bt.items()}))
    return out


def _assert_close_to_scale(got, want, what):
    """rtol 1e-6, atol 1e-6 of ``want``'s largest magnitude."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


def _assert_state_matches(model, state, jparams, jstate):
    want_p = param_arrays(jax.tree_util.tree_map(np.asarray, jparams), model)
    for k, p in model.named_parameters():
        _assert_close_to_scale(p.detach().numpy(), want_p[k], k)
    for mine, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        want = param_arrays(jax.tree_util.tree_map(np.asarray, ref), model)
        for k, t in mine.items():
            _assert_close_to_scale(t.numpy(), want[k], k)
    assert int(state.step) == int(jstate.step)


def test_two_tower_step_continues_reference():
    """Two reference steps, the state carried across, then the third step
    in both packages: loss and gradients, and the update from the
    reference's own gradients."""
    jarch, arch = (jax_get_arch("two-tower-retrieval"),
                   get_arch("two-tower-retrieval"))
    jcfg, cfg = jarch.config(reduced=True), arch.config(reduced=True)
    jparams = jarch.init(jcfg, KEY)
    jstate = jopt.init_adamw(jparams)
    jstep = jarch.step_fn(jcfg, "train_batch")
    batches = _tt_batches(cfg, 32, 3, seed=1)
    for jb, _ in batches[:2]:
        jparams, jstate, _ = jstep(jparams, jstate, jb)
    model = port_two_tower(jparams, cfg)
    state = port_adamw_state(jstate, model)
    _assert_state_matches(model, state, jparams, jstate)

    jb, tb = batches[2]
    jloss_fn = functools.partial(jrecsys.two_tower_loss, jcfg)
    jl, jg = jax.value_and_grad(jloss_fn)(jparams, jb)
    loss, grads = value_and_grad(arch.loss_fn(cfg, "train_batch"), model, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    for k, g in grads.items():
        assert_grad_close(g.numpy(), want[k], rtol=1e-4, what=k)

    jparams3, jstate3 = jopt.adamw_update(jarch.opt, jg, jstate, jparams)
    _, state3 = adamw_update(arch.opt, {k: torch.tensor(a)
                                        for k, a in want.items()},
                             state, model)
    _assert_state_matches(model, state3, jparams3, jstate3)


# ---------------------------------------------------------------------------
# PNA molecule
# ---------------------------------------------------------------------------


def test_pna_shapes():
    arch = get_arch("pna")
    cfg = arch.config(reduced=True, shape="molecule")
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_adamw(model)
    _, ospecs, batch_s = arch.abstract_inputs(cfg, "molecule", reduced=True)
    assert {k: v.shape for k, v in batch_s.items()} == {
        "feats": (4, 12, 8), "adj": (4, 12, 12), "labels": (4,)}
    batch = _materialize(batch_s, seed=0, int_hi=2)
    step = arch.step_fn(cfg, "molecule", reduced=True)
    _, opt2, loss = step(model, opt, batch)
    assert np.isfinite(float(loss)), f"pna/molecule loss {loss}"
    assert _finite(model) and int(opt2.step) == 1


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products"])
def test_pna_sparse_and_minibatch_shapes(shape):
    """The reference's ``test_pna_shapes`` for the sparse and minibatch
    cells: one step of the arch at its REDUCED shape on random batches
    (integers in [0, 2)), finite loss and parameters."""
    arch = get_arch("pna")
    cfg = arch.config(reduced=True, shape=shape)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_adamw(model)
    _, _, batch_s = arch.abstract_inputs(cfg, shape, reduced=True)
    batch = _materialize(batch_s, seed=0, int_hi=2)
    before = {k: p.clone() for k, p in model.named_parameters()}
    _, opt2, loss = arch.step_fn(cfg, shape, reduced=True)(model, opt, batch)
    assert np.isfinite(float(loss)), f"pna/{shape} loss {loss}"
    assert _finite(model) and int(opt2.step) == 1
    assert all(not torch.equal(p, before[k])
               for k, p in model.named_parameters())


@pytest.mark.parametrize("b", [4, 32])
def test_pna_loss_dense_and_grads_match_reference(b):
    jarch, arch = jax_get_arch("pna"), get_arch("pna")
    jcfg = jarch.config(reduced=True, shape="molecule")
    cfg = arch.config(reduced=True, shape="molecule")
    jparams = jarch.init(jcfg, KEY)
    model = port_pna(jparams, cfg)
    adj, feats = molecule_graphs(b, 12, cfg.d_in, seed=b)
    labels = np.random.default_rng(b).integers(0, 2, b).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jgnn.loss_dense(
        jcfg, p, jnp.asarray(feats), jnp.asarray(adj), jnp.asarray(labels),
        use_kernel=False))(jparams)
    batch = {"feats": torch.from_numpy(feats), "adj": torch.from_numpy(adj),
             "labels": torch.from_numpy(labels)}
    loss, grads = value_and_grad(arch.loss_fn(cfg, "molecule", reduced=True),
                                 model, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    for k, g in grads.items():
        assert_grad_close(g.numpy(), want[k], rtol=1e-4, what=k)
    # the plain aggregator gives the kernel route's loss (CPU: the same)
    np.testing.assert_allclose(
        float(loss_dense(cfg, model, batch["feats"], batch["adj"],
                         batch["labels"], use_kernel=True)), float(loss),
        rtol=1e-6)


def test_pna_step_continues_reference():
    jarch, arch = jax_get_arch("pna"), get_arch("pna")
    jcfg = jarch.config(reduced=True, shape="molecule")
    cfg = arch.config(reduced=True, shape="molecule")
    jparams = jarch.init(jcfg, KEY)
    jstate = jopt.init_adamw(jparams)
    jstep = jarch.step_fn(jcfg, "molecule", reduced=True)
    adj, feats = molecule_graphs(8, 12, cfg.d_in, seed=3)
    labels = np.arange(8, dtype=np.int32) % 2
    jb = {"feats": jnp.asarray(feats), "adj": jnp.asarray(adj),
          "labels": jnp.asarray(labels)}
    jparams, jstate, _ = jstep(jparams, jstate, jb)
    model = port_pna(jparams, cfg)
    state = port_adamw_state(jstate, model)
    jl, jg = jax.value_and_grad(lambda p: jgnn.loss_dense(
        jcfg, p, jb["feats"], jb["adj"], jb["labels"],
        use_kernel=False))(jparams)
    jparams2, jstate2 = jopt.adamw_update(jarch.opt, jg, jstate, jparams)
    want = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    _, state2 = adamw_update(arch.opt, {k: torch.tensor(a)
                                        for k, a in want.items()},
                             state, model)
    _assert_state_matches(model, state2, jparams2, jstate2)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def test_launcher_batches_equal_reference():
    jarch = jax_get_arch("two-tower-retrieval")
    arch = get_arch("two-tower-retrieval")
    jit = jlaunch.make_data_iter(jarch, jarch.config(reduced=True),
                                 "train_batch")
    it = launch.make_data_iter(arch, arch.config(reduced=True),
                               "train_batch", device="cpu")
    for _ in range(3):
        jb, tb = next(jit), next(it)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == {"logq": torch.float32}.get(k, torch.int32)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("arch_id", ["dien", "sasrec", "dcn-v2"])
def test_launcher_batches_of_recsys_arches_equal_reference(arch_id):
    """The launcher's batches for DIEN, SASRec and DCN-v2: the reference
    launcher's keys, dtypes and values (DIEN's ``mask`` ones and ``label``
    normal, SASRec's ``neg`` ids in [0, 4))."""
    jarch, arch = jax_get_arch(arch_id), get_arch(arch_id)
    jit = jlaunch.make_data_iter(jarch, jarch.config(reduced=True),
                                 "train_batch")
    it = launch.make_data_iter(arch, arch.config(reduced=True),
                               "train_batch", device="cpu")
    for _ in range(2):
        jb, tb = next(jit), next(it)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert str(tb[k].dtype) == "torch." + str(jb[k].dtype)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    if arch_id == "dien":
        assert bool((tb["mask"] == 1).all()) and tb["label"].min() < 0
    if arch_id == "sasrec":
        assert tb["neg"].shape == (32, 10, 64) and int(tb["neg"].max()) <= 3


@pytest.mark.parametrize("arch_id", ["dien", "dcn-v2"])
def test_launcher_trains_recsys_arches_on_cpu(arch_id, capsys):
    res = launch.main(["--arch", arch_id, "--device", "cpu", "--steps", "6"])
    assert res["steps"] == 6 and res["shape"] == "train_batch"
    assert np.isfinite([v for _, v in res["losses"]]).all()
    assert f"{arch_id}/train_batch: 6 steps" in capsys.readouterr().out
    assert _finite(res["params"])


def _reference_launcher_losses(arch_id, steps):
    """The reference launcher's loop (``repro.launch.train.main``) logging
    every step: its probe loss, its data, its AdamW."""
    arch = jax_get_arch(arch_id)
    shape = jlaunch._train_shape(arch)
    cfg = arch.config(reduced=True, shape=shape)
    params = arch.init(cfg, KEY)
    step = arch.step_fn(cfg, shape)

    def loss_fn(p, batch):
        _, _, loss = step(p, jopt.init_adamw(p), batch)
        return loss

    res = jloop.run(loss_fn, params, jlaunch.make_data_iter(arch, cfg, shape),
                    jloop.TrainConfig(total_steps=steps, log_every=1,
                                      ckpt_dir=None),
                    jopt.AdamWConfig(lr=1e-3,
                                     warmup_steps=max(steps // 10, 1),
                                     total_steps=steps))
    return params, res["losses"]


@pytest.mark.parametrize("arch_id,port,rtol", [
    ("two-tower-retrieval", port_two_tower, 1e-4),
    ("pna", port_pna, 1e-5),
    ("sasrec", port_recsys, 1e-4)])
def test_launcher_first_losses_equal_reference(arch_id, port, rtol):
    jparams, want = _reference_launcher_losses(arch_id, 5)
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True, shape=launch._train_shape(arch))
    res = launch.train(arch_id, steps=5, device="cpu",
                       model=port(jparams, cfg), log_every=1)
    assert [s for s, _ in res["losses"]] == [s for s, _ in want] == list(
        range(5))
    np.testing.assert_allclose([v for _, v in res["losses"]],
                               [v for _, v in want], rtol=rtol)


def test_launcher_resumes_and_learns(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--arch", "two-tower-retrieval", "--device", "cpu",
            "--ckpt-dir", d, "--ckpt-every", "5"]
    first = launch.main(argv + ["--steps", "10"])
    resumed = launch.main(argv + ["--steps", "20"])
    assert first["steps"] == 10 and resumed["steps"] == 10
    assert resumed["losses"][0][0] == 10
    assert resumed["losses"][-1][1] < first["losses"][0][1]
    out = capsys.readouterr().out
    assert "two-tower-retrieval/train_batch: 10 steps" in out
    assert _finite(resumed["params"])


def test_launcher_pna_resumes_and_logs_finite_losses(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--arch", "pna", "--device", "cpu", "--ckpt-dir", d,
            "--ckpt-every", "4"]
    first = launch.main(argv + ["--steps", "8"])
    resumed = launch.main(argv + ["--steps", "12"])
    assert first["steps"] == 8 and resumed["steps"] == 4
    # logged every 10 steps and at the last: the resumed run starts at 8
    assert [s for s, _ in resumed["losses"]] == [10, 11]
    losses = [v for _, v in first["losses"] + resumed["losses"]]
    assert np.isfinite(losses).all()
    assert "pna/full_graph_sm: 8 steps" in capsys.readouterr().out
    assert _finite(resumed["params"])


def test_launcher_arch_choices():
    assert launch.TRAIN_ARCH_IDS == [
        "smollm-360m", "gemma3-27b", "qwen3-8b", "moonshot-v1-16b-a3b",
        "deepseek-v2-lite-16b", "pna", "dien", "two-tower-retrieval",
        "sasrec", "dcn-v2"]
    assert set(launch.TRAIN_ARCH_IDS) == set(jlaunch.ARCH_IDS)
