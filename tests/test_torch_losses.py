"""The port's losses against the JAX reference on the same numpy inputs:
``cross_entropy`` (with a mask, with labels counted from the end, and
with out-of-range labels, which give NaN as the reference's ``"fill"``
gather does), ``bce_with_logits``, and the two-tower ``two_tower_loss``
with its gradients at the REDUCED config, the reference's parameters
carried across.  The blocked in-batch softmax equals its plain version at
B in {1, 7, 64} with blocks that do not divide B.

Tolerances: losses within rtol 1e-5 (fp32, sums in another order);
gradients within rtol 1e-4 and atol 1e-6, the atol times the gradient's
largest magnitude where that exceeds 1 (``assert_grad_close``: the
backward's matmuls and a table row's scatter-adds run in another order;
at temperature 0.05 the table gradients reach ~10, where one fp32 ulp is
~1e-6, so a fixed atol of 1e-6 would sit below fp32's resolution);
blocked against plain on the same device: the loss within rtol 1e-6 /
atol 1e-7, gradients within rtol 1e-5 and the same atol (one more fp32
rounding per block).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import common as jcommon
from repro.models import recsys as jrecsys
from repro_torch.configs import get_arch
from repro_torch.convert import param_arrays
from repro_torch.models.common import bce_with_logits, cross_entropy
from repro_torch.models.recsys import (InBatchSoftmax, in_batch_softmax,
                                       in_batch_softmax_ref, two_tower_loss,
                                       two_tower_score_candidates)
from repro_torch.train.loop import value_and_grad
from torch_parity import assert_grad_close, port_two_tower

ARCH = get_arch("two-tower-retrieval")
JARCH = jax_get_arch("two-tower-retrieval")


def _ce_inputs(seed, shape=(6, 5)):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    mask = (rng.random(shape[:-1]) < 0.6).astype(np.float32)
    return logits, labels, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("labels_kind", ["in_range", "from_end",
                                         "too_large", "too_small"])
def test_cross_entropy_matches_reference(masked, labels_kind):
    logits, labels, mask = _ce_inputs(seed=len(labels_kind) + masked)
    c = logits.shape[-1]
    if labels_kind == "from_end":
        labels[::2] -= c                  # [-C, 0): counted from the end
    elif labels_kind == "too_large":
        labels[1] = c + 2                 # outside [-C, C): NaN
    elif labels_kind == "too_small":
        labels[2] = -c - 1
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = float(jcommon.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), jm))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), tm))
    if labels_kind in ("too_large", "too_small"):
        assert np.isnan(want) and np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cross_entropy_gradients_match_reference():
    """Gradients, bf16 logits (computed in fp32) and a masked-out NaN row
    (its gradient is 0 in both packages)."""
    logits, labels, mask = _ce_inputs(seed=3, shape=(4, 3, 7))
    labels[0, 1] = 9
    mask[0, 1] = 0.0
    jg = jax.grad(lambda x: jcommon.cross_entropy(
        x, jnp.asarray(labels), jnp.asarray(mask)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    (tg,) = torch.autograd.grad(cross_entropy(
        t, torch.from_numpy(labels), torch.from_numpy(mask)), t)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    assert np.isfinite(tg.numpy()).all()
    lb = logits.astype(jnp.bfloat16)
    want = float(jcommon.cross_entropy(jnp.asarray(lb), jnp.asarray(labels)
                                       .clip(0, 6)))
    got = cross_entropy(torch.from_numpy(logits).bfloat16(),
                        torch.from_numpy(labels).clamp(0, 6))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_bce_with_logits_matches_reference(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(33,)) * 10).astype(np.float32)
    labels = rng.integers(0, 2, size=33).astype(np.float32)
    want = float(jcommon.bce_with_logits(jnp.asarray(logits),
                                         jnp.asarray(labels)))
    got = float(bce_with_logits(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# two-tower: in-batch sampled softmax with logQ correction
# ---------------------------------------------------------------------------


def _softmax_inputs(b, e, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, e)).astype(np.float32)
    v = rng.normal(size=(b, e)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    logq = np.log(rng.dirichlet(np.ones(b))).astype(np.float32)
    return [torch.from_numpy(a).requires_grad_() for a in (u, v, logq)]


@pytest.mark.parametrize("b,block", [(1, 1), (1, 4096), (7, 3), (7, 2),
                                     (64, 5), (64, 17), (64, 64)])
def test_blocked_softmax_equals_plain(b, block):
    u, v, logq = _softmax_inputs(b, 16, seed=b + block)
    want = in_batch_softmax_ref(u, v, logq, 0.05)
    got = in_batch_softmax(u, v, logq, 0.05, block=block)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    gw = torch.autograd.grad(want, (u, v, logq))
    gg = torch.autograd.grad(got, (u, v, logq))
    for a, w in zip(gg, gw):
        assert_grad_close(a, w, rtol=1e-5)


def test_blocked_softmax_gradcheck():
    """The hand-written backward against finite differences, in float64."""
    u, v, logq = (t.detach().double().requires_grad_()
                  for t in _softmax_inputs(9, 4, seed=2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: InBatchSoftmax.apply(a, b, c, 0.5, 4), (u, v, logq))


@pytest.fixture(scope="module")
def reduced():
    jcfg = JARCH.config(reduced=True)
    jparams = JARCH.init(jcfg, jax.random.PRNGKey(0))
    cfg = ARCH.config(reduced=True)
    return jcfg, jparams, cfg


def _tt_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    batch = {"user_id": rng.integers(-1, cfg.n_users, size=b),
             "user_feats": rng.integers(-1, cfg.n_users,
                                        size=(b, cfg.n_user_feats)),
             "item_id": rng.integers(0, cfg.n_items, size=b),
             "logq": rng.normal(size=b) - 3.0}
    batch = {k: v.astype(np.float32 if k == "logq" else np.int32)
             for k, v in batch.items()}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("b", [1, 32, 100])
def test_two_tower_loss_and_grads_match_reference(reduced, b):
    jcfg, jparams, cfg = reduced
    model = port_two_tower(jparams, cfg)
    jb, tb = _tt_batch(cfg, b, seed=b)
    jl, jg = jax.value_and_grad(
        functools.partial(jrecsys.two_tower_loss, jcfg))(jparams, jb)
    loss, grads = value_and_grad(
        lambda m, bt: two_tower_loss(cfg, m, bt, block=7), model, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        assert_grad_close(g.numpy(), want[k], rtol=1e-4, what=k)
    assert not any(p.requires_grad for p in model.parameters())


def test_score_candidates_matches_reference(reduced):
    jcfg, jparams, cfg = reduced
    model = port_two_tower(jparams, cfg)
    jb, tb = _tt_batch(cfg, 4, seed=9)
    cand = np.random.default_rng(9).normal(size=(50, 16)).astype(np.float32)
    want = jrecsys.two_tower_score_candidates(jcfg, jparams, jb,
                                              jnp.asarray(cand))
    got = two_tower_score_candidates(cfg, model, tb, torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
