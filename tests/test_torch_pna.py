"""PNA's dense-batched inference in the PyTorch port against the JAX
reference, at the ``molecule`` shape.

The reference's ``init_pna`` parameters cross over as numpy
(``pna_params_from_arrays``), so both packages run the same weights, and
the reference runs ``forward_dense(use_kernel=True)``: its Pallas kernel in
interpret mode.  Logits agree within atol 2e-3, the tolerance the
reference itself holds its kernel route to its plain route at
(``tests/test_models_smoke.py:166``): what sets it is the std block's
cancellation (up to ~sqrt(eps) |h| for a node of degree 1), carried
through the layers' ``w_upd`` products.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import gnn as jgnn
from repro_torch.configs import get_arch
from repro_torch.configs.lm_common import TensorSpec
from repro_torch.kernels.pna_aggregate import pna_aggregate_cuda
from repro_torch.models.common import param_count
from repro_torch.models.gnn import (PNA, _scale, forward_dense, init_pna,
                                    set_pna_params)
from torch_parity import cuda_device, molecule_graphs, port_pna  # noqa: F401

KEY = jax.random.PRNGKey(0)
ARCH = get_arch("pna")
JARCH = jax_get_arch("pna")
LOGITS_ATOL = 2e-3


def _models(reduced):
    jcfg = JARCH.config(reduced=reduced, shape="molecule")
    jparams = JARCH.init(jcfg, KEY)
    cfg = ARCH.config(reduced=reduced, shape="molecule")
    return jcfg, jparams, cfg, port_pna(jparams, cfg)


@pytest.mark.parametrize("reduced,b,n", [(True, 4, 12), (False, 4, 30)],
                         ids=["reduced", "full_width"])
def test_forward_dense_matches_reference(reduced, b, n):
    jcfg, jparams, cfg, model = _models(reduced)
    adj, feats = molecule_graphs(b, n, cfg.d_in, seed=n)
    want = jgnn.forward_dense(jcfg, jparams, jnp.asarray(feats),
                              jnp.asarray(adj), use_kernel=True)
    got = forward_dense(cfg, model, torch.from_numpy(feats),
                        torch.from_numpy(adj))
    assert got.shape == (b, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL)


def test_scale_matches_reference_per_graph():
    rng = np.random.default_rng(0)
    agg = rng.normal(size=(3, 7, 8)).astype(np.float32)
    deg = rng.integers(0, 4, size=(3, 7)).astype(np.float32)
    got = _scale(torch.from_numpy(agg), torch.from_numpy(deg), 2.0).numpy()
    for g in range(3):
        np.testing.assert_allclose(
            got[g], np.asarray(jgnn._scale(jnp.asarray(agg[g]),
                                           jnp.asarray(deg[g]), 2.0)),
            rtol=1e-6)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_config_matches_reference(shape, reduced):
    got = ARCH.config(reduced=reduced, shape=shape)
    want = JARCH.config(reduced=reduced, shape=shape)
    for fld in dataclasses.fields(want):
        if fld.name != "dtype":
            assert getattr(got, fld.name) == getattr(want, fld.name), fld.name
    assert got.dtype == torch.float32 and want.dtype == jnp.float32


def test_shapes_and_cells_match_reference():
    from repro.configs import pna as jpna
    from repro_torch.configs import pna
    assert pna.PNA_SHAPES == jpna.PNA_SHAPES
    assert pna.REDUCED_SHAPES == jpna.REDUCED_SHAPES
    assert ([(c.shape, c.kind, c.skip) for c in ARCH.cells()]
            == [(c.shape, c.kind, c.skip) for c in JARCH.cells()])


def test_params_match_reference_shapes():
    cfg = ARCH.config(shape="molecule")
    specs = ARCH.abstract_params(cfg)
    jtree = JARCH.abstract_params(JARCH.config(shape="molecule"))
    want = {"enc": jtree["enc"].shape, "dec": jtree["dec"].shape}
    for i, lp in enumerate(jtree["layers"]):
        want[f"layers.{i}.w_msg"] = lp["w_msg"].shape
        want[f"layers.{i}.w_upd"] = lp["w_upd"].shape
    assert {k: v.shape for k, v in specs.items()} == want
    assert all(isinstance(v, TensorSpec) and v.dtype == torch.float32
               for v in specs.values())
    assert isinstance(ARCH.module(cfg), PNA)
    assert next(ARCH.module(cfg).parameters()).device.type == "meta"
    assert param_count(ARCH.module(cfg)) == param_count(jtree)


def test_init_follows_the_reference_law():
    cfg = ARCH.config(shape="molecule")
    model = init_pna(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    w = model.layers[0].w_upd
    assert w.shape == (975, 75)
    assert abs(float(w.std()) - 975 ** -0.5) < 0.05 * 975 ** -0.5
    again = init_pna(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(model.dec, again.dec)


def test_card_matches_cpu(cuda_device):
    cfg = ARCH.config(shape="molecule")
    model = init_pna(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device=cuda_device)
    adj, feats = molecule_graphs(16, 30, cfg.d_in, seed=5)
    before = pna_aggregate_cuda.launches
    got = forward_dense(cfg, model, torch.from_numpy(feats).to(cuda_device),
                        torch.from_numpy(adj).to(cuda_device))
    assert pna_aggregate_cuda.launches == before + cfg.n_layers
    cpu = set_pna_params(PNA(cfg), model.enc.cpu(), model.dec.cpu(),
                         [(lp.w_msg.cpu(), lp.w_upd.cpu())
                          for lp in model.layers])
    want = forward_dense(cfg, cpu, torch.from_numpy(feats),
                         torch.from_numpy(adj))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               atol=LOGITS_ATOL)
