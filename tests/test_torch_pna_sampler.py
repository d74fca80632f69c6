"""PNA's neighbour sampler and minibatch regime in the PyTorch port against
the JAX reference.

``build_csr`` and ``sample_fanout`` are numpy on the host in both packages:
given the same ``np.random.Generator`` state they must return bit-identical
``indptr``, ``indices``, ``nodes``, ``blocks`` and ``seed_idx`` (nodes with
no in-edge sample themselves, duplicate seeds collapse, the deepest hop
comes first).  ``forward_minibatch`` on a sampled block, and one
``minibatch_lg`` step (loss, gradients, one AdamW update), then run in both
packages on the reference's weights carried across; a 4-layer model
leaves layers 3-4 out of the loss (the reference zips 4 layers with 2
blocks), so their gradients are zero and AdamW only decays them.

Tolerances: logits within atol 2e-4 and rtol 1e-4 (fp32, the std block's
float64 moments against the reference's fp32 ones); losses within rtol
1e-5; parameters and moments after one update from the reference's own
gradients within rtol 1e-6 and 1e-6 of each tensor's largest magnitude.
Gradients by ``torch_parity.assert_grad_close`` at rtol 1e-4 against the
reference's float64 run (``jax.enable_x64``), and within 4x the
reference's own fp32 noise of its fp32 run
(``torch_parity.assert_grad_within_noise``): the std block's 5e5 gradient
at var ~ 0 turns the reference's fp32 rounding into ~0.5-1 % (relative
L2) of gradient noise in the early layers; sampling with replacement
repeats edges, so such nodes are common here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.convert import param_arrays
from repro_torch.models import gnn
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import adamw_update
from torch_parity import (assert_grad_close,  # noqa: F401
                          assert_grad_within_noise, one_thread,
                          port_adamw_state, port_pna, reference_grads64)

pytestmark = pytest.mark.usefixtures("one_thread")
KEY = jax.random.PRNGKey(0)
ARCH, JARCH = get_arch("pna"), jax_get_arch("pna")


def _graph(n, e, seed, isolated=0):
    """A random edge list over n nodes; the last ``isolated`` nodes have no
    in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - isolated, e).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("n,e,isolated", [(50, 400, 0), (500, 4000, 37),
                                          (7, 3, 4)])
def test_build_csr_bit_identical(n, e, isolated):
    src, dst = _graph(n, e, seed=n, isolated=isolated)
    got = gnn.build_csr(n, src, dst)
    want = jgnn.build_csr(n, src, dst)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,e,isolated,n_seeds,fanouts", [
    (500, 4000, 0, 32, (5, 3)),
    (300, 900, 60, 64, (4, 2)),        # self-loops for nodes with no in-edge
    (40, 200, 5, 80, (3, 3, 2)),       # duplicate seeds, three hops
    (1000, 20000, 0, 8, (15, 10)),     # the cell's fanouts
])
def test_sample_fanout_bit_identical(n, e, isolated, n_seeds, fanouts):
    src, dst = _graph(n, e, seed=e, isolated=isolated)
    indptr, indices = gnn.build_csr(n, src, dst)
    seeds = np.random.default_rng(1).integers(0, n, n_seeds).astype(np.int32)
    got = gnn.sample_fanout(indptr, indices, seeds, fanouts,
                            np.random.default_rng(7))
    want = jgnn.sample_fanout(indptr, indices, seeds, fanouts,
                              np.random.default_rng(7))
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == len(fanouts)
    for (gs, gd), (ws, wd) in zip(got[1], want[1]):
        for g, w in ((gs, ws), (gd, wd)):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2])
    # deepest hop first: the last block's destinations are the seeds
    assert set(got[1][-1][1]) == set(got[2])
    if isolated:       # a node without an in-edge samples itself
        lone = got[0] >= n - isolated
        s, d = got[1][-1]
        hit = lone[d]
        assert hit.any() and (s[hit] == d[hit]).all()


def _sampled_block(seed, n=600, e=5000, d_in=8, fanouts=(5, 3)):
    src, dst = _graph(n, e, seed=seed, isolated=20)
    indptr, indices = gnn.build_csr(n, src, dst)
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, n, 32).astype(np.int32)
    nodes, blocks, seed_idx = gnn.sample_fanout(indptr, indices, seeds,
                                                fanouts, rng)
    feats = rng.normal(size=(len(nodes), d_in)).astype(np.float32)
    return nodes, blocks, seed_idx, feats


def test_forward_minibatch_on_a_sampled_block():
    nodes, blocks, _, feats = _sampled_block(3)
    jcfg = jgnn.PNAConfig(n_layers=2, d_in=8, d_hidden=16, n_classes=5)
    cfg = gnn.PNAConfig(n_layers=2, d_in=8, d_hidden=16, n_classes=5)
    jparams = jgnn.init_pna(jcfg, KEY)
    model = port_pna(jparams, cfg)
    want = jgnn.forward_minibatch(
        jcfg, jparams, jnp.asarray(feats),
        [(jnp.asarray(s), jnp.asarray(d)) for s, d in blocks], len(nodes))
    with torch.no_grad():
        got = gnn.forward_minibatch(
            cfg, model, torch.from_numpy(feats),
            [(torch.from_numpy(s), torch.from_numpy(d)) for s, d in blocks],
            len(nodes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-4)


def _minibatch(spec, d_in, classes, seed):
    """A ``minibatch_lg`` batch at ``spec``'s shapes from one sampled
    block, padded as the cell's fixed shapes are: block-local indices, the
    padding edges' dst -1 (dropped) and src 0."""
    nb = spec["block_nodes"]
    e2, e1 = spec["hop_edges"]
    rng = np.random.default_rng(seed)
    n = 4 * nb
    src, dst = _graph(n, 8 * n, seed=seed, isolated=3)
    indptr, indices = gnn.build_csr(n, src, dst)
    seeds = rng.choice(n - 3, spec["seeds"], replace=False).astype(np.int32)
    nodes, blocks, seed_idx = gnn.sample_fanout(indptr, indices, seeds,
                                                spec["fanouts"], rng)
    assert len(nodes) <= nb

    def pad(a, size, fill):
        return np.concatenate([a, np.full(size - len(a), fill, np.int32)])

    (s2, d2), (s1, d1) = blocks
    feats = np.zeros((nb, d_in), np.float32)
    feats[:len(nodes)] = rng.normal(size=(len(nodes), d_in))
    return {"feats": feats,
            "src2": pad(s2, e2, 0), "dst2": pad(d2, e2, -1),
            "src1": pad(s1, e1, 0), "dst1": pad(d1, e1, -1),
            "seed_idx": seed_idx.astype(np.int32),
            "labels": rng.integers(0, classes, spec["seeds"]).astype(
                np.int32)}


def _jax_minibatch_loss(jcfg):
    from repro.models.common import cross_entropy

    def loss(p, jb):
        logits = jgnn.forward_minibatch(
            jcfg, p, jb["feats"], [(jb["src2"], jb["dst2"]),
                                   (jb["src1"], jb["dst1"])],
            jb["feats"].shape[0])
        return cross_entropy(logits[jb["seed_idx"]], jb["labels"])
    return loss


@pytest.mark.parametrize("n_layers", [2, 4])
def test_minibatch_step_matches_reference(n_layers):
    """Loss, gradients and one AdamW step of ``minibatch_lg`` (REDUCED
    shapes) against the reference; with 4 layers, layers 3-4 get zero
    gradients and change by weight decay alone, in both packages."""
    from repro_torch.configs.pna import REDUCED_SHAPES
    spec = REDUCED_SHAPES["minibatch_lg"]
    jcfg = dataclasses.replace(JARCH.config(True, "minibatch_lg"),
                               n_layers=n_layers)
    cfg = dataclasses.replace(ARCH.config(True, "minibatch_lg"),
                              n_layers=n_layers)
    batch = _minibatch(spec, cfg.d_in, cfg.n_classes, seed=n_layers)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jparams = JARCH.init(jcfg, KEY)
    jstate = jopt.init_adamw(jparams)
    model = port_pna(jparams, cfg)
    state = port_adamw_state(jstate, model)

    jl, jg = jax.jit(jax.value_and_grad(_jax_minibatch_loss(jcfg)))(jparams,
                                                                     jb)
    want64 = param_arrays(reference_grads64(_jax_minibatch_loss(jcfg),
                                            jparams, batch), model)
    loss, grads = value_and_grad(ARCH.loss_fn(cfg, "minibatch_lg", True),
                                 model, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = param_arrays(jax.tree_util.tree_map(np.asarray, jg), model)
    for k, g in grads.items():
        assert_grad_close(g.numpy(), want64[k], rtol=1e-4, what=k)
        assert_grad_within_noise(g.numpy(), want[k], want64[k], what=k)
    unused = [f"layers.{i}.{w}" for i in range(2, n_layers)
              for w in ("w_msg", "w_upd")]
    for k in unused:
        assert not grads[k].any() and not want[k].any(), k
    assert all(grads[k].any() for k in grads if k not in unused)

    # one update from the reference's own gradients in both packages
    jp2, js2 = jopt.adamw_update(JARCH.opt, jg, jstate, jparams)
    before = {k: p.clone() for k, p in model.named_parameters()}
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
    lr = float(jopt.schedule(JARCH.opt, jnp.int32(1)))
    for k in unused:           # zero moments; decay alone moved them
        assert not state2.mu[k].any() and not state2.nu[k].any()
        p0 = before[k]
        now = dict(model.named_parameters())[k]
        torch.testing.assert_close(now, p0 - lr * (p0 * ARCH.opt.weight_decay),
                                   rtol=1e-6, atol=0)
        assert not torch.equal(now, p0)
    assert int(state2.step) == int(js2.step) == 1

    # the arch's step: the same loss as the reference's step
    model = port_pna(jparams, cfg)
    _, _, jl_step = jax.jit(JARCH.step_fn(jcfg, "minibatch_lg", True))(
        jparams, jopt.init_adamw(jparams), jb)
    _, _, l_step = ARCH.step_fn(cfg, "minibatch_lg", True)(
        model, port_adamw_state(jopt.init_adamw(jparams), model), tb)
    np.testing.assert_allclose(float(l_step), float(jl_step), rtol=1e-5)
