"""The five LM arches of the port (``configs/lm_common.py`` and the five
configs) against the JAX reference: twins of ``tests/test_models_smoke.py``'s
LM tests (``test_lm_train_step``, ``test_lm_prefill_and_decode``,
``test_gemma3_long_context_cell_enabled``); the configs, cells, abstract
inputs and parameter counts; ``model_flops``; the ``train_4k`` step
continued from a reference step (the parameters and the AdamW state carried
across with ``convert.lm_params_from_arrays`` /
``adamw_state_from_arrays``); the ``prefill_32k`` and ``decode_32k`` steps.

Tolerances: losses and logits within rtol 1e-5 (atol 1e-5); parameters and
moments after one ``adamw_update`` from the reference's own gradients
within rtol 1e-6 and 1e-6 of each tensor's largest magnitude, after the
port's whole step (its own gradients) within rtol 1e-4 and 1e-5 of it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import lm_common as jlm
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.configs.lm_common import (LM_SHAPES, REDUCED_SHAPES,
                                           model_flops)
from repro_torch.convert import param_arrays
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import adamw_update, init_adamw
from torch_parity import (one_thread, port_adamw_state,  # noqa: F401
                          port_lm)

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
LM_ARCHS = ["smollm-360m", "gemma3-27b", "qwen3-8b", "moonshot-v1-16b-a3b",
            "deepseek-v2-lite-16b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _materialize(specs, seed, int_hi):
    """numpy arrays for a dict of ``TensorSpec``: integers in [0, int_hi),
    floats standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in specs.items():
        if s.dtype.is_floating_point:
            out[name] = rng.normal(size=s.shape).astype(np.float32)
        else:
            out[name] = rng.integers(0, int_hi, s.shape).astype(np.int32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference(arch_id):
    jarch = jax_get_arch(arch_id)
    jcfg = jarch.config(reduced=True)
    return jarch, jcfg, jarch.init(jcfg, KEY)


# ---------------------------------------------------------------------------
# twins of tests/test_models_smoke.py's LM tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_train_step(arch_id):
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_adamw(model)
    _, _, batch_s = arch.abstract_inputs(cfg, "train_4k", reduced=True)
    batch = _torch(_materialize(batch_s, 0, cfg.vocab))
    before = {k: p.clone() for k, p in model.named_parameters()}
    model2, opt2, loss = arch.step_fn(cfg, "train_4k")(model, opt, batch)
    assert model2 is model and np.isfinite(float(loss)), f"{arch_id} {loss}"
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert int(opt2.step) == 1
    assert max(float((p - before[k]).abs().max())
               for k, p in model.named_parameters()) > 0
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_prefill_and_decode(arch_id):
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch_s = arch.abstract_inputs(cfg, "prefill_32k", reduced=True)
    batch = _torch(_materialize(batch_s, 0, cfg.vocab))
    logits, cache = arch.step_fn(cfg, "prefill_32k")(model, batch)
    b, s = batch["tokens"].shape
    assert tuple(logits.shape) == (b, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert tuple(cache[0].shape[:3]) == (cfg.n_layers, b, s)

    _, cache_s, dbatch_s = arch.abstract_inputs(cfg, "decode_32k",
                                                reduced=True)
    rng = np.random.default_rng(1)
    cache = tuple(torch.from_numpy(rng.normal(size=c.shape).astype(
        np.float32)) for c in cache_s)
    dbatch = _torch(_materialize(dbatch_s, 1, cfg.vocab))
    dbatch["pos"] = torch.tensor(3, dtype=torch.int32)
    logits2, cache2 = arch.step_fn(cfg, "decode_32k")(model, cache, dbatch)
    assert logits2.shape[-1] == cfg.vocab
    assert bool(torch.isfinite(logits2).all())
    assert [tuple(c.shape) for c in cache2] == [c.shape for c in cache_s]


def test_gemma3_long_context_cell_enabled():
    arch = get_arch("gemma3-27b")
    cells = {c.shape: c for c in arch.cells()}
    assert cells["long_500k"].skip is None
    for a in ["smollm-360m", "qwen3-8b", "moonshot-v1-16b-a3b",
              "deepseek-v2-lite-16b"]:
        assert {c.shape: c for c in get_arch(a).cells()}[
            "long_500k"].skip is not None


# ---------------------------------------------------------------------------
# configs, cells, inputs, counts
# ---------------------------------------------------------------------------


def _specs(tree):
    """{name: (shape, dtype name)} of a batch struct (either package)."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_configs_cells_and_inputs_match_reference(arch_id):
    jarch, arch = jax_get_arch(arch_id), get_arch(arch_id)
    assert [(c.shape, c.kind, c.skip) for c in arch.cells()] == [
        (c.shape, c.kind, c.skip) for c in jarch.cells()]
    for reduced in (False, True):
        mine = dataclasses.asdict(arch.config(reduced=reduced))
        ref = dataclasses.asdict(jarch.config(reduced=reduced))
        assert {k: v for k, v in mine.items() if k != "dtype"} == {
            k: v for k, v in ref.items() if k != "dtype"}
        assert (mine["dtype"] == torch.float32) == (
            ref["dtype"] == jnp.float32)
    assert (LM_SHAPES, REDUCED_SHAPES) == (jlm.LM_SHAPES, jlm.REDUCED_SHAPES)
    cfg, jcfg = arch.config(reduced=True), jarch.config(reduced=True)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        mine = arch.abstract_inputs(cfg, shape, reduced=True)
        ref = jarch.abstract_inputs(jcfg, shape, reduced=True)
        want = param_arrays(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), ref[0]),
            arch.module(cfg))
        assert {k: v.shape for k, v in want.items()} == {
            k: s.shape for k, s in mine[0].items()}
        assert _specs(mine[-1]) == _specs(ref[-1])
        if shape == "train_4k":
            assert mine[1].mu.keys() == want.keys()
        elif shape != "prefill_32k":
            assert [(s.shape, s.dtype) for s in mine[1]] == [
                (s.shape, torch.float32) for s in ref[1]]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_param_counts_and_model_flops_match_reference(arch_id):
    """Arithmetic only, at the FULL configs; the REDUCED model's
    parameters number ``param_count`` (and the qk-norm gains)."""
    cfg = get_arch(arch_id).config()
    jcfg = jax_get_arch(arch_id).config()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.vdim() == jcfg.vdim()
    for train in (False, True):
        assert model_flops(cfg, 4096 * 256, train) == jlm.model_flops(
            jcfg, 4096 * 256, train)
    # the reference's count leaves out the qk-norm gains (2 hd a layer)
    small = get_arch(arch_id).config(reduced=True)
    model = get_arch(arch_id).module(small)
    qk = 2 * small.head_dim * small.n_layers if small.qk_norm else 0
    assert sum(p.numel() for p in model.parameters()) == (
        small.param_count() + qk)


def test_in_shardings_wait_for_the_mesh_rules():
    """The mesh rules answer (their parity with the reference's is
    ``tests/test_torch_sharding.py``'s); ``loss_fn`` takes train cells
    only."""
    from repro_torch.distributed.sharding import AbstractMesh
    arch = get_arch("qwen3-8b")
    pspecs, opt_specs, batch = arch.in_shardings(
        arch.config(), "train_4k", AbstractMesh((16, 16), ("data", "model")))
    assert set(pspecs) == set(arch.abstract_params(arch.config()))
    assert opt_specs.mu == pspecs and tuple(batch["tokens"]) == ("data", None)
    with pytest.raises(ValueError, match="not a train cell"):
        arch.loss_fn(arch.config(reduced=True), "decode_32k")


# ---------------------------------------------------------------------------
# the cells' steps against the reference
# ---------------------------------------------------------------------------


def _assert_close_to_scale(got, want, what, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_train_step_continues_reference(arch_id):
    """One reference step, its parameters and state carried across, then
    the second step: the loss in both packages; the update from the
    reference's own gradients; the port's whole step (its own
    gradients)."""
    jarch, jcfg, jparams = _reference(arch_id)
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    jstep = jax.jit(jarch.step_fn(jcfg, "train_4k"))
    _, _, batch_s = arch.abstract_inputs(cfg, "train_4k", reduced=True)
    b1 = _materialize(batch_s, 2, cfg.vocab)
    jparams, jstate, _ = jstep(jparams, jopt.init_adamw(jparams),
                               {k: jnp.asarray(v) for k, v in b1.items()})
    b2 = _materialize(batch_s, 3, cfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in b2.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jb["tokens"], jb["labels"])))(jparams)
    jparams2, jstate2, jl2 = jstep(jparams, jstate, jb)
    np.testing.assert_allclose(float(jl2), float(jl), rtol=1e-6)

    model = port_lm(jparams, cfg)
    state = port_adamw_state(jstate, model)
    loss, _ = value_and_grad(arch.loss_fn(cfg, "train_4k"), model,
                             _torch(b2))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want_g = param_arrays(_np(jg), model)
    _, state2 = adamw_update(arch.opt, {k: torch.tensor(a)
                                        for k, a in want_g.items()},
                             state, model)
    want_p = param_arrays(_np(jparams2), model)
    for k, p in model.named_parameters():
        _assert_close_to_scale(p.numpy(), want_p[k], k)
    for mine, ref in ((state2.mu, jstate2.mu), (state2.nu, jstate2.nu)):
        want = param_arrays(_np(ref), model)
        for k, t in mine.items():
            _assert_close_to_scale(t.numpy(), want[k], k)
    assert int(state2.step) == int(jstate2.step) == 2

    model = port_lm(jparams, cfg)
    state = port_adamw_state(jstate, model)
    _, state3, loss3 = arch.step_fn(cfg, "train_4k")(model, state,
                                                      _torch(b2))
    np.testing.assert_allclose(float(loss3), float(jl), rtol=1e-5)
    for k, p in model.named_parameters():
        _assert_close_to_scale(p.numpy(), want_p[k], k, 1e-4, 1e-5)
    for mine, ref in ((state3.mu, jstate2.mu), (state3.nu, jstate2.nu)):
        want = param_arrays(_np(ref), model)
        for k, t in mine.items():
            _assert_close_to_scale(t.numpy(), want[k], k, 1e-4, 1e-5)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_prefill_step_matches_reference(arch_id):
    jarch, jcfg, jparams = _reference(arch_id)
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    model = port_lm(jparams, cfg)
    _, batch_s = arch.abstract_inputs(cfg, "prefill_32k", reduced=True)
    batch = _materialize(batch_s, 4, cfg.vocab)
    jl, jcache = jarch.step_fn(jcfg, "prefill_32k")(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = arch.step_fn(cfg, "prefill_32k")(model, _torch(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(cache, jcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert not logits.requires_grad
