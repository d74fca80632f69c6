"""``models/transformer.py`` and the LM pieces of ``models/common.py`` of the
port against the JAX reference, at the five LM arches' REDUCED configs.

The reference's own weights cross over (``convert.lm_params_from_arrays``,
the stacked (L, ...) layers sliced per layer) and numpy-seeded tokens go
through both packages: ``rms_norm`` and ``apply_rope``; ``forward``
logits; ``lm_loss`` and every gradient; ``prefill`` logits and caches;
``decode_step`` at positions 0, 3, 9 (gemma3's window of 8 crossed), the
last and past the cache (the reference's clamped write); ``attn_chunk``
and ``remat`` set by ``dataclasses.replace``; ``moe_ffn`` with dropped
tokens and with tied router gates; the init laws; a bf16 forward of the
dense arches against the reference's own bf16 run.

Tolerances: logits, caches and losses within rtol 1e-5 and atol 1e-5
(fp32); gradients within 1e-5 relative L2 per parameter; the bf16
forward within 3e-2 relative L2 of the reference's bf16 logits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.convert import param_arrays
from repro_torch.models import common
from repro_torch.models import transformer as tt
from repro_torch.train.loop import value_and_grad
from torch_parity import one_thread, port_lm  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
ARCHES = ["smollm-360m", "qwen3-8b", "gemma3-27b", "deepseek-v2-lite-16b",
          "moonshot-v1-16b-a3b"]
MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2 = 1e-5


@functools.lru_cache(maxsize=None)
def _reference(arch_id, **replace):
    """(reference config, its params, port config) at REDUCED, each config
    with ``replace`` applied."""
    jcfg = dataclasses.replace(
        jax_get_arch(arch_id).config(reduced=True), **replace)
    cfg = dataclasses.replace(get_arch(arch_id).config(reduced=True),
                              **replace)
    return jcfg, jax_get_arch(arch_id).init(jcfg, KEY), cfg


def _setup(arch_id, **replace):
    jcfg, jparams, cfg = _reference(arch_id, **replace)
    return jcfg, jparams, cfg, port_lm(jparams, cfg)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want)) / (
        float(np.linalg.norm(want)) or 1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# models/common.py: rms_norm and RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32) * 3.0
    w = rng.normal(size=24).astype(np.float32) * 0.1
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    want = jcommon.rms_norm(jnp.asarray(x).astype(jd),
                            jnp.asarray(w).astype(jd))
    got = common.rms_norm(torch.from_numpy(x).to(td),
                          torch.from_numpy(w).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)))
    # float64 stays float64 (the CPU copies' reference runs)
    x64 = torch.from_numpy(x).double()
    assert common.rms_norm(x64, torch.from_numpy(w)).dtype == torch.float64


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference_interleaved(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         theta))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(
        common.rope_freqs(16, theta).numpy(),
        np.asarray(jcommon.rope_freqs(16, theta)), rtol=1e-6)
    # pairs (0, 1), (2, 3), ... rotate: at position 1 the first pair turns
    # by 1 rad, not the pair (0, hd / 2) of rotate_half
    e = torch.zeros((1, 1, 1, 16))
    e[..., 0] = 1.0
    out = common.apply_rope(e, torch.ones((1, 1), dtype=torch.int32), theta)
    np.testing.assert_allclose(out[0, 0, 0, :2].numpy(),
                               [np.cos(1.0), np.sin(1.0)], rtol=1e-6)
    assert not out[0, 0, 0, 8].item()


def test_masks_and_layer_pattern_match_reference():
    for s, w in ((7, 0), (9, 3)):
        np.testing.assert_array_equal(tt._causal_mask(s, w).numpy(),
                                      np.asarray(jt._causal_mask(s, w)))
    for arch_id in ARCHES:
        for reduced in (False, True):
            np.testing.assert_array_equal(
                get_arch(arch_id).config(reduced=reduced)
                .layer_is_global().numpy(),
                np.asarray(jax_get_arch(arch_id).config(reduced=reduced)
                           .layer_is_global()))


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHES)
def test_forward_loss_and_grads_match_reference(arch_id):
    jcfg, jparams, cfg, model = _setup(arch_id)
    tok = _tokens(cfg, 2, 16, seed=3)
    labels = _tokens(cfg, 2, 16, seed=4)
    np.testing.assert_allclose(
        tt.forward(cfg, model, torch.from_numpy(tok)).numpy(),
        np.asarray(jt.forward(jcfg, jparams, jnp.asarray(tok))), **TOL)
    _assert_loss_and_grads(jcfg, jparams, cfg, model, tok, labels)


def _assert_loss_and_grads(jcfg, jparams, cfg, model, tok, labels):
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(tok),
                             jnp.asarray(labels))))(jparams)
    loss, grads = value_and_grad(
        lambda m, b: tt.lm_loss(cfg, m, b["tokens"], b["labels"]), model,
        {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = param_arrays(_np(jg), model)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        err = _rel_l2(g.numpy(), want[k])
        assert err <= GRAD_REL_L2, f"{k}: relative L2 {err:.3g}"
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch_id", ["qwen3-8b", "gemma3-27b",
                                     "deepseek-v2-lite-16b"])
def test_attn_chunk_and_remat_match_reference(arch_id):
    """``attn_chunk`` = 8 (four query chunks of the 32-token batch) and
    ``remat``: the logits, loss and gradients of the reference's chunked,
    checkpointed run; the chunked attention equals the unchunked one."""
    jcfg, jparams, cfg, model = _setup(arch_id, attn_chunk=8, remat=True)
    tok = _tokens(cfg, 2, 32, seed=5)
    labels = _tokens(cfg, 2, 32, seed=6)
    got = tt.forward(cfg, model, torch.from_numpy(tok))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jt.forward(jcfg, jparams, jnp.asarray(tok))),
        **TOL)
    whole = tt.forward(dataclasses.replace(cfg, attn_chunk=0, remat=False),
                       model, torch.from_numpy(tok))
    torch.testing.assert_close(got, whole, **TOL)
    _assert_loss_and_grads(jcfg, jparams, cfg, model, tok, labels)


def test_remat_checkpoints_each_layer(monkeypatch):
    """Under grad with ``remat`` each layer runs in a non-reentrant
    checkpoint; without grad, or without ``remat``, none does."""
    _, _, cfg, model = _setup("gemma3-27b", remat=True)
    calls = []
    real = tt.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)
    monkeypatch.setattr(tt, "checkpoint", spy)
    tok = torch.from_numpy(_tokens(cfg, 1, 8, seed=7))
    value_and_grad(lambda m, b: tt.forward(cfg, m, b).sum(), model, tok)
    assert calls == [False] * cfg.n_layers
    with torch.no_grad():
        tt.forward(cfg, model, tok)
    value_and_grad(lambda m, b: tt.forward(
        dataclasses.replace(cfg, remat=False), m, b).sum(), model, tok)
    assert len(calls) == cfg.n_layers


def test_embedding_reads_follow_jnp_indexing():
    """A negative token wraps once, one still out of range reads the end
    row and sends it no gradient, as the reference's ``embed[tokens]``."""
    jcfg, jparams, cfg, model = _setup("qwen3-8b")
    tok = _tokens(cfg, 1, 6, seed=8)
    tok[0, :3] = [-1, cfg.vocab + 5, -cfg.vocab - 2]
    np.testing.assert_allclose(
        tt.forward(cfg, model, torch.from_numpy(tok)).numpy(),
        np.asarray(jt.forward(jcfg, jparams, jnp.asarray(tok))), **TOL)
    jg = jax.grad(lambda p: jt.forward(jcfg, p, jnp.asarray(tok)).sum())(
        jparams)
    _, g = value_and_grad(lambda m, b: tt.forward(cfg, m, b).sum(), model,
                          torch.from_numpy(tok))
    assert _rel_l2(g["embed"].numpy(), np.asarray(jg["embed"])) <= 1e-5


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _assert_cache(got, want):
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("arch_id", ARCHES)
@pytest.mark.parametrize("max_seq", [16, 24])
def test_prefill_matches_reference(arch_id, max_seq):
    jcfg, jparams, cfg, model = _setup(arch_id)
    tok = _tokens(cfg, 2, 16, seed=9)
    jl, jcache = jt.prefill(jcfg, jparams, jnp.asarray(tok), max_seq)
    with torch.no_grad():
        logits, cache = tt.prefill(cfg, model, torch.from_numpy(tok),
                                   max_seq)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_cache(cache, jcache)


# decode positions in a 32-row cache: 0, 3, 9 (gemma3's window of 8
# crossed), the last, and two past the end (the write clamps to row 31)
DECODE_POS = (0, 3, 9, 31, 34)


@pytest.mark.parametrize("arch_id", ARCHES)
def test_decode_steps_match_reference(arch_id):
    """Steps from a random cache, each side fed its own cache: logits and
    caches at every position of ``DECODE_POS``; the port writes in place
    and returns the tensors it was given."""
    jcfg, jparams, cfg, model = _setup(arch_id)
    arch = get_arch(arch_id)
    _, cache_s, _ = arch.abstract_inputs(cfg, "decode_32k", reduced=True)
    rng = np.random.default_rng(10)
    host = [rng.normal(size=s.shape).astype(np.float32) for s in cache_s]
    jcache = tuple(jnp.asarray(a) for a in host)
    cache = tuple(torch.from_numpy(a.copy()) for a in host)
    step = arch.step_fn(cfg, "decode_32k")
    jstep = jax_get_arch(arch_id).step_fn(jcfg, "decode_32k")
    for i, pos in enumerate(DECODE_POS):
        tok = _tokens(cfg, 4, 1, seed=11 + i)
        jl, jcache = jstep(jparams, jcache, {
            "tokens": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32)})
        logits, out = step(model, cache, {
            "tokens": torch.from_numpy(tok),
            "pos": torch.tensor(pos, dtype=torch.int32)})
        assert out[0] is cache[0] and out[1] is cache[1]
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   err_msg=f"pos {pos}", **TOL)
        _assert_cache(cache, jcache)


def test_quirk_decode_write_clamps_past_the_cache():
    """``lax.dynamic_update_slice`` clamps its start: a step at pos >= Smax
    writes row Smax - 1 (RoPE still at pos), and the prefill-style write
    of s rows at pos > Smax - s lands at Smax - s."""
    _, _, cfg, model = _setup("smollm-360m")
    cache = tt.init_cache(cfg, 1, 8, device="cpu")
    tok = torch.from_numpy(_tokens(cfg, 1, 1, seed=12))
    with torch.no_grad():
        tt.decode_step(cfg, model, cache, tok, torch.tensor(11))
    written = cache[0].abs().sum(dim=(0, 1, 3, 4)) > 0
    assert written.tolist() == [False] * 7 + [True]
    c = torch.zeros((1, 8, 2))
    tt._write_cache(c, torch.ones((1, 3, 2)), 7)
    tt._write_cache(c, torch.full((1, 2, 2), 2.0), torch.tensor(-4))
    assert c[0, :, 0].tolist() == [2, 2, 0, 0, 0, 1, 1, 1]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", MOE)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(arch_id, capacity_factor):
    """At capacity factor 0.5 an expert keeps at most half its fair share:
    tokens are dropped, and both packages drop the same ones."""
    jcfg, jparams, cfg, model = _setup(arch_id,
                                       capacity_factor=capacity_factor)
    x = np.random.default_rng(13).normal(
        size=(3, 16, cfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    want = np.asarray(jt.moe_ffn(jcfg, lp, jnp.asarray(x)))
    got = tt.moe_ffn(cfg, model.layers[0], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _, topi = tt.moe_route(cfg, model.layers[0],
                           torch.from_numpy(x).reshape(-1, cfg.d_model))
    load = torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
    cap = int(np.ceil(48 * cfg.top_k / cfg.n_experts * capacity_factor))
    if capacity_factor < 1:
        assert int((load - cap).clamp_min(0).sum()) > 0


def test_moe_top_k_ties_take_the_lower_expert():
    """Router columns 2 = 5 and 3 = 6 tie every gate exactly: the top k
    take the lower ids first, as ``lax.top_k``; outputs equal the
    reference's, and two runs give the same bits."""
    jcfg, jparams, cfg = _reference("moonshot-v1-16b-a3b")
    tree = jax.tree_util.tree_map(np.array, jparams)
    router = tree["layers"]["router"]
    router[..., 5], router[..., 6] = router[..., 2], router[..., 3]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = port_lm(jparams, cfg)
    x = np.random.default_rng(14).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    _, topi = tt.moe_route(cfg, model.layers[0], xt.reshape(-1, cfg.d_model))
    jgates = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model)
                            @ jparams["layers"]["router"][0], axis=-1)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(
        jax.lax.top_k(jgates, cfg.top_k)[1]))
    assert not bool(((topi == 5) | (topi == 6)).all(dim=-1).any())
    lp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    got = tt.moe_ffn(cfg, model.layers[0], xt)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jt.moe_ffn(jcfg, lp, jnp.asarray(x))), **TOL)
    assert torch.equal(tt.moe_ffn(cfg, model.layers[0], xt), got)


# ---------------------------------------------------------------------------
# init and the bf16 path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHES)
def test_init_law_and_seed(arch_id):
    """Shapes and dtypes as ``abstract_params``; each matrix's std, pooled
    over the layers, within 5 % of 1/sqrt(fan_in) (0.02 for the
    embedding); norms zero; no grad; the same seed the same draw."""
    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.config(reduced=True), n_layers=6)
    model = arch.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    specs = arch.abstract_params(cfg)
    named = dict(model.named_parameters())
    assert {k: (tuple(p.shape), p.dtype) for k, p in named.items()} == {
        k: (s.shape, s.dtype) for k, s in specs.items()}
    assert not any(p.requires_grad for p in named.values())
    pooled = {}
    for k, p in named.items():
        pooled.setdefault(k.split(".")[-1], []).append(p)
    for name, ps in pooled.items():
        flat = torch.cat([p.reshape(-1) for p in ps]).double()
        if ps[0].dim() == 1:
            assert not flat.any(), name
            continue
        want = 0.02 if name == "embed" else ps[0].shape[-2] ** -0.5
        assert abs(float(flat.std()) / want - 1) < 0.05, name
        assert abs(float(flat.mean())) < 0.05 * want, name
    again = arch.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    other = arch.init(cfg, torch.Generator().manual_seed(2), device="cpu")
    assert all(torch.equal(p, again.get_parameter(k))
               for k, p in named.items())
    assert not torch.equal(model.embed, other.embed)


@pytest.mark.parametrize("arch_id", ["smollm-360m", "qwen3-8b",
                                     "gemma3-27b"])
def test_bf16_forward_near_reference_bf16(arch_id):
    """The dense arches in bf16 (the FULL dtype), the reference's bf16
    weights carried across: logits within 3e-2 relative L2 of the
    reference's own bf16 run."""
    jcfg, jparams, cfg, model = _bf16_setup(arch_id)
    tok = _tokens(cfg, 2, 16, seed=15)
    got = tt.forward(cfg, model, torch.from_numpy(tok))
    want = jt.forward(jcfg, jparams, jnp.asarray(tok))
    assert got.dtype == torch.float32
    assert model.embed.dtype == torch.bfloat16
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 3e-2


def _bf16_setup(arch_id):
    jcfg = dataclasses.replace(jax_get_arch(arch_id).config(reduced=True),
                               dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_arch(arch_id).config(reduced=True),
                              dtype=torch.bfloat16)
    jparams = jax_get_arch(arch_id).init(jcfg, KEY)
    return jcfg, jparams, cfg, port_lm(jparams, cfg)
