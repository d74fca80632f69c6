"""PNA's sparse regime in the PyTorch port against the JAX reference.

* ``pna_aggregate_segment_ref`` drops edges whose ``dst`` lies outside
  [0, N), as ``jax.ops.segment_*`` do (the cells pad their edge lists with
  ``dst = -1``); ``take_rows`` reads and differentiates rows as ``jnp``
  indexing does (a negative index wraps once, the rest is clamped, and an
  index still out of range passes no gradient).
* ``SegmentAggregate`` (the streamed layer) against the plain layer
  ``pna_layer_sparse_ref`` at ``EDGE_CHUNK`` = 1, 7 and E, with tied
  maxima and minima, and ``torch.autograd.gradcheck`` in float64.
* ``forward_sparse``, ``loss_sparse``, gradients and one AdamW step of the
  ``full_graph_sm`` and ``ogb_products`` REDUCED cells against the
  reference, its weights carried across; ``abstract_inputs`` of every
  cell.

Tolerances: segment outputs of integer-valued messages (exact sums in
both packages) within rtol 1e-6, their mean / max / min gradients within
rtol 1e-6; streamed against plain in float64 within rtol 1e-9 (the same
arithmetic, summed in another order), in fp32 across ``EDGE_CHUNK`` within
rtol 1e-5 and an atol of 1e-6 of the largest magnitude; logits within
rtol 1e-4 and atol 2e-4 (the plain layer 2e-3, as
``tests/test_torch_pna.py``); losses within rtol 1e-5; parameters and moments
after one update from the reference's own gradients within rtol 1e-6 and
1e-6 of each tensor's largest magnitude.  Gradients by
``torch_parity.assert_grad_close`` at rtol 1e-4 against the reference's
float64 run (``jax.enable_x64``), and within 4x the reference's own fp32
noise of its fp32 run (``assert_grad_within_noise``): the reference's fp32
gradients of the early layers stand ~0.5-0.8 % (relative L2) from its
float64 run, because the std block's 5e5 gradient at var ~ 0 magnifies
fp32 rounding, while the port's (float64 sums and moments) stand ~3e-7
from it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.pna_aggregate.ref import \
    pna_aggregate_segment_ref as jseg_ref
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.configs.lm_common import TensorSpec
from repro_torch.convert import param_arrays
from repro_torch.kernels.pna_aggregate import pna_aggregate_segment_ref
from repro_torch.models import gnn
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import adamw_update
from torch_parity import (assert_grad_close,  # noqa: F401
                          assert_grad_within_noise, one_thread,
                          port_adamw_state, port_pna, reference_grads64)

pytestmark = pytest.mark.usefixtures("one_thread")
KEY = jax.random.PRNGKey(0)
ARCH, JARCH = get_arch("pna"), jax_get_arch("pna")


# ---------------------------------------------------------------------------
# the plain aggregator and the row gather
# ---------------------------------------------------------------------------


def _int_messages(e, f, n, bad, seed):
    """Integer-valued messages (ties in max and min, exact sums in fp32)
    to ``dst`` over n nodes: the last 3 nodes have no in-edge, every 5th
    edge points at ``bad`` (outside [0, n))."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(-3, 4, (e, f)).astype(np.float32)
    dst = rng.integers(0, n - 3, e).astype(np.int32)
    dst[::5] = bad
    return msgs, dst


@pytest.mark.parametrize("bad", ["-1", "N", "N+5"])
def test_segment_ref_drops_out_of_range_dst(bad):
    n, e, f = 12, 90, 5
    msgs, dst = _int_messages(e, f, n, {"-1": -1, "N": n, "N+5": n + 5}[bad],
                              seed=len(bad))
    want = np.asarray(jseg_ref(jnp.asarray(msgs), jnp.asarray(dst), n))
    m = torch.from_numpy(msgs).requires_grad_()
    got = pna_aggregate_segment_ref(m, torch.from_numpy(dst), n)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    lone = got.detach()[n - 3:]              # no in-edge: 0, 0, 0, 1e-6
    assert not lone[:, :3 * f].any()
    torch.testing.assert_close(lone[:, 3 * f:], torch.full((3, f), 1e-6))
    # mean / max / min gradients, ties split evenly in both packages
    r = np.random.default_rng(9).normal(size=(n, 3 * f)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(
        jseg_ref(x, jnp.asarray(dst), n)[:, :3 * f] * r))(jnp.asarray(msgs))
    (g,) = torch.autograd.grad((got[:, :3 * f] * torch.from_numpy(r)).sum(),
                               m)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    dropped = torch.from_numpy((dst < 0) | (dst >= n))
    assert dropped.any() and not g[dropped].any()


def test_take_rows_matches_jnp_indexing():
    h = np.arange(12, dtype=np.float32).reshape(4, 3) + 1.0
    idx = np.array([-1, 4, 5, -5, -8, 0, 2, -4, 3], np.int32)
    want = np.asarray(jnp.asarray(h)[jnp.asarray(idx)])
    t = torch.from_numpy(h).requires_grad_()
    got = gnn.take_rows(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    w = np.random.default_rng(0).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(x[jnp.asarray(idx)] * w))(jnp.asarray(h))
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), t)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    # the gradient of the clamped reads is dropped: row 0 is read by -5
    # and -8 but only 0 and -4 pass a gradient to it
    np.testing.assert_allclose(g[0].numpy(), w[5] + w[7], rtol=1e-6)


# ---------------------------------------------------------------------------
# SegmentAggregate: the streamed layer against the plain one
# ---------------------------------------------------------------------------


def _layer_inputs(n, e, f, dtype, seed, ties=True):
    """h (n, f), one layer's weights, and an edge list over n nodes with
    out-of-range src and dst, repeated edges (tied messages) and nodes
    without an in-edge."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(n, f))).to(dtype)
    lay = gnn.PNALayer(f, dtype)
    lay.w_msg = torch.nn.Parameter(torch.from_numpy(
        rng.normal(size=(f, f)) / f ** 0.5).to(dtype))
    lay.w_upd = torch.nn.Parameter(torch.from_numpy(
        rng.normal(size=(13 * f, f)) / (13 * f) ** 0.5).to(dtype))
    src = rng.integers(-n - 2, n + 2, e).astype(np.int32)
    dst = rng.integers(-1, n - 2, e).astype(np.int32)
    dst[::7] = n + 1
    if ties:
        src[e // 2:] = src[:e - e // 2]
        dst[e // 2:] = dst[:e - e // 2]
    return h, lay, torch.from_numpy(src), torch.from_numpy(dst)


def _layer_grads(layer, h, lay, src, dst, n, r):
    h = h.clone().requires_grad_()
    out = layer(lay, h, src, dst, n, 2.0)
    grads = torch.autograd.grad((out * r).sum(), (h, lay.w_msg, lay.w_upd))
    return (out.detach(),) + grads


@pytest.mark.parametrize("chunk", ["1", "7", "E"])
def test_segment_aggregate_matches_plain_layer(chunk, monkeypatch):
    n, e, f = 30, 160, 6
    monkeypatch.setattr(gnn, "EDGE_CHUNK", {"1": 1, "7": 7, "E": e}[chunk])
    h, lay, src, dst = _layer_inputs(n, e, f, torch.float64, seed=1)
    r = torch.from_numpy(np.random.default_rng(2).normal(size=(n, f)))
    got = _layer_grads(gnn.pna_layer_sparse, h, lay, src, dst, n, r)
    want = _layer_grads(gnn.pna_layer_sparse_ref, h, lay, src, dst, n, r)
    for a, b, what in zip(got, want, ("out", "h", "w_msg", "w_upd")):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, msg=what)
    # the five reductions against the plain sums (fp32 messages)
    h32, w32 = h.float(), lay.w_msg.detach().float()
    cnt, s, ssq, hmax, hmin = gnn.SegmentAggregate.apply(h32, w32, src, dst,
                                                         n)
    assert s.dtype == ssq.dtype == cnt.dtype == torch.float64
    assert hmax.dtype == torch.float32
    msgs = gnn.take_rows(h32, src) @ w32
    agg = pna_aggregate_segment_ref(msgs, dst, n)
    has = cnt[:, None] > 0
    torch.testing.assert_close(torch.where(has, hmax, 0.0), agg[:, f:2 * f],
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.where(has, hmin, 0.0),
                               agg[:, 2 * f:3 * f], rtol=0, atol=0)
    torch.testing.assert_close((s / cnt.clamp_min(1)[:, None]).float(),
                               agg[:, :f], rtol=1e-5, atol=1e-6)
    keep = (dst >= 0) & (dst < n)
    assert int(cnt.sum()) == int(keep.sum())


def test_segment_aggregate_independent_of_chunk_fp32(monkeypatch):
    n, e, f = 40, 300, 5
    h, lay, src, dst = _layer_inputs(n, e, f, torch.float32, seed=3)
    r = torch.from_numpy(np.random.default_rng(4).normal(
        size=(n, f))).float()
    runs = []
    for chunk in (1, 7, e):
        monkeypatch.setattr(gnn, "EDGE_CHUNK", chunk)
        runs.append(_layer_grads(gnn.pna_layer_sparse, h, lay, src, dst, n,
                                 r))
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            torch.testing.assert_close(
                a, b, rtol=1e-5, atol=1e-6 * max(1.0, float(b.abs().max())))


def test_segment_aggregate_gradcheck(monkeypatch):
    monkeypatch.setattr(gnn, "EDGE_CHUNK", 4)
    n, f = 7, 3
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(n, f))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(f, f))).requires_grad_()
    # in-range (or wrapping) sources: a clamped read passes no gradient,
    # which finite differences would see
    src = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1, -7, 2, 3], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3, 3, 0, 0, 5, -1, 2, n, 5], dtype=torch.int32)

    def reductions(h, w):
        cnt, s, ssq, hmax, hmin = gnn.SegmentAggregate.apply(h, w, src, dst,
                                                             n)
        has = cnt[:, None] > 0
        return (s, ssq, torch.where(has, hmax, 0.0),
                torch.where(has, hmin, 0.0))
    assert torch.autograd.gradcheck(reductions, (h, w))


# ---------------------------------------------------------------------------
# the sparse cells against the reference
# ---------------------------------------------------------------------------

SPARSE = ["full_graph_sm", "ogb_products"]
# logits' atol: the plain layer's fp32 sums leave the std block's
# cancellation (up to ~sqrt(eps) |h| where a node's messages nearly agree)
# to its order of summation, as tests/test_torch_pna.py holds it; the
# streamed layer sums in float64
LOGITS_ATOL = {"streamed": 2e-4, "plain": 2e-3}


def _sparse_batch(shape, seed):
    """A REDUCED sparse batch: uniform edges, the last 1/16 of them padding
    (dst -1), labels for 3/4 of the nodes."""
    from repro_torch.configs.pna import REDUCED_SHAPES
    spec = REDUCED_SHAPES[shape]
    n, e = spec["n_nodes"], spec["n_edges"]
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[-e // 16:] = -1
    return {"feats": rng.normal(size=(n, spec["d_feat"])).astype(np.float32),
            "src": src, "dst": dst,
            "labels": rng.integers(0, spec["classes"], n).astype(np.int32),
            "label_mask": (rng.random(n) < 0.75).astype(np.float32)}


def _both(shape, seed=0):
    jcfg, cfg = JARCH.config(True, shape), ARCH.config(True, shape)
    jparams = JARCH.init(jcfg, KEY)
    batch = _sparse_batch(shape, seed)
    return (jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
            cfg, port_pna(jparams, cfg),
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("shape", SPARSE)
@pytest.mark.parametrize("layer", ["streamed", "plain"])
def test_forward_sparse_matches_reference(shape, layer):
    jcfg, jparams, jb, cfg, model, tb = _both(shape, seed=1)
    want = jax.jit(functools.partial(jgnn.forward_sparse, jcfg))(
        jparams, jb["feats"], jb["src"], jb["dst"])
    fn = {"streamed": gnn.pna_layer_sparse,
          "plain": gnn.pna_layer_sparse_ref}[layer]
    with torch.no_grad():
        got = gnn.forward_sparse(cfg, model, tb["feats"], tb["src"],
                                 tb["dst"], layer=fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=LOGITS_ATOL[layer])


def _jax_loss(jcfg):
    def loss(p, jb):
        return jgnn.loss_sparse(jcfg, p, jb["feats"], jb["src"], jb["dst"],
                                jb["labels"], jb["label_mask"])
    return loss


@pytest.mark.parametrize("shape", SPARSE)
def test_loss_sparse_and_grads_match_reference(shape):
    jcfg, jparams, jb, cfg, model, tb = _both(shape, seed=2)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(jcfg)))(jparams, jb)
    loss, grads = value_and_grad(ARCH.loss_fn(cfg, shape, reduced=True),
                                 model, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    want64 = param_arrays(reference_grads64(_jax_loss(jcfg), jparams, jb),
                          model)
    for k, g in grads.items():
        assert_grad_close(g.numpy(), want64[k], rtol=1e-4, what=k)
        assert_grad_within_noise(g.numpy(), want[k], want64[k], what=k)
    # loss_sparse itself, checkpointed under grad and plain without
    with torch.no_grad():
        plain = gnn.loss_sparse(cfg, model, tb["feats"], tb["src"],
                                tb["dst"], tb["labels"], tb["label_mask"],
                                layer=gnn.pna_layer_sparse_ref)
    np.testing.assert_allclose(float(plain), float(jl), rtol=1e-5)


@pytest.mark.parametrize("shape", SPARSE)
def test_sparse_step_matches_reference(shape):
    """The arch's step against the reference's step_fn (the loss), and one
    ``adamw_update`` from the reference's own gradients."""
    jcfg, jparams, jb, cfg, model, tb = _both(shape, seed=3)
    jstate = jopt.init_adamw(jparams)
    state = port_adamw_state(jstate, model)
    jp2, js2, jl = jax.jit(JARCH.step_fn(jcfg, shape, reduced=True))(
        jparams, jstate, jb)
    jg = jax.jit(jax.grad(_jax_loss(jcfg)))(jparams, jb)
    want = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    _, state2 = adamw_update(ARCH.opt, {k: torch.tensor(a)
                                        for k, a in want.items()},
                             state, model)
    for mine, ref in ((dict(model.named_parameters()), jp2),
                      (state2.mu, js2.mu), (state2.nu, js2.nu)):
        ref = param_arrays(jax.tree_util.tree_map(np.asarray, ref), model)
        for k, t in mine.items():
            np.testing.assert_allclose(
                t.numpy(), ref[k], rtol=1e-6,
                atol=1e-6 * float(np.abs(ref[k]).max()), err_msg=k)
    model = port_pna(jparams, cfg)
    _, opt, loss = ARCH.step_fn(cfg, shape, reduced=True)(
        model, port_adamw_state(jstate, model), tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert int(opt.step) == 1
    assert not any(p.requires_grad for p in model.parameters())


def _shape_dtype(spec):
    return tuple(spec.shape), str(spec.dtype).replace("torch.", "")


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_abstract_inputs_match_reference(shape, reduced):
    cfg, jcfg = ARCH.config(reduced, shape), JARCH.config(reduced, shape)
    params, opt, batch = ARCH.abstract_inputs(cfg, shape, reduced=reduced)
    jparams, jopt_s, jbatch = JARCH.abstract_inputs(jcfg, shape,
                                                    reduced=reduced)
    assert {k: _shape_dtype(v) for k, v in batch.items()} == {
        k: (v.shape, np.dtype(v.dtype).name) for k, v in jbatch.items()}
    flat = {"enc": jparams["enc"], "dec": jparams["dec"]}
    for i, lp in enumerate(jparams["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    assert {k: _shape_dtype(v) for k, v in params.items()} == {
        k: (v.shape, "float32") for k, v in flat.items()}
    assert all(isinstance(v, TensorSpec) for v in opt.mu.values())
    assert {k: v.shape for k, v in opt.mu.items()} == {
        k: v.shape for k, v in flat.items()}
    assert _shape_dtype(opt.step) == (jopt_s.step.shape,
                                      np.dtype(jopt_s.step.dtype).name)
