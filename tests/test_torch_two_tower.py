"""The two-tower retrieval arch in the PyTorch port against the JAX
reference, at the REDUCED config.

The reference's ``init_two_tower`` parameters cross over as numpy
(``two_tower_params_from_arrays``), so both packages run the same weights.
Embeddings and serve scores agree within atol 1e-5 (fp32 products summed
in different orders); retrieval ids are identical except at near ties
(``NEAR_TIE_REL``), with scores within 1e-5 and the same -inf padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import recsys as jrecsys
from repro_torch.configs import get_arch
from repro_torch.convert import two_tower_params_from_arrays
from repro_torch.kernels.filtered_topk import filtered_topk_cuda
from repro_torch.models.common import param_count
from repro_torch.models.recsys import default_lookup, init_two_tower
from torch_parity import assert_ids_match

KEY = jax.random.PRNGKey(0)
ARCH = get_arch("two-tower-retrieval")
JARCH = jax_get_arch("two-tower-retrieval")


@pytest.fixture(scope="module")
def models():
    """(reference cfg, reference params, port cfg, port model on CPU)."""
    jcfg = JARCH.config(reduced=True)
    jparams = JARCH.init(jcfg, KEY)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = ARCH.config(reduced=True)
    return jcfg, jparams, cfg, two_tower_params_from_arrays(tree, cfg,
                                                            device="cpu")


def _batch(cfg, b, seed):
    """numpy batch with -1 padding and out-of-range ids (clipped)."""
    rng = np.random.default_rng(seed)
    batch = {
        "user_id": rng.integers(-1, cfg.n_users + 3, size=b),
        "user_feats": rng.integers(-1, cfg.n_users, size=(b, cfg.n_user_feats)),
        "item_id": rng.integers(-1, cfg.n_items + 3, size=b),
        "logq": np.zeros(b),
    }
    batch = {k: v.astype(np.float32 if k == "logq" else np.int32)
             for k, v in batch.items()}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_default_lookup_matches_reference():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(10, 3)).astype(np.float32)
    ids = np.array([[-1, 0, 9, 12], [3, -5, 4, 10]], np.int32)
    want = np.asarray(jrecsys.default_lookup(jnp.asarray(table),
                                             jnp.asarray(ids)))
    got = default_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [1, 8])
def test_embeddings_match_reference(models, b):
    jcfg, jparams, cfg, model = models
    jb, tb = _batch(cfg, b, seed=b)
    np.testing.assert_allclose(
        model.user_embed(tb).numpy(),
        np.asarray(jrecsys.user_embed(jcfg, jparams, jb)), atol=1e-5)
    ids = np.arange(-1, cfg.n_items + 2, dtype=np.int32)
    np.testing.assert_allclose(
        model.item_embed(torch.from_numpy(ids)).numpy(),
        np.asarray(jrecsys.item_embed(jcfg, jparams, jnp.asarray(ids))),
        atol=1e-5)


def _retrieval_inputs(cfg, p):
    """The batch, candidates and mask of the reference's
    test_two_tower_retrieval_matches_bruteforce (mask density ``p``)."""
    rng = np.random.default_rng(0)
    batch = {"user_id": np.asarray([3], np.int32),
             "user_feats": rng.integers(0, 8, (1, 2)).astype(np.int32),
             "item_id": np.asarray([1], np.int32),
             "logq": np.zeros((1,), np.float32)}
    cand = rng.normal(size=(256, cfg.tower_dims[-1])).astype(np.float32)
    mask = rng.random((1, 256)) < p
    return batch, cand, mask


@pytest.mark.parametrize("p", [0.5, 0.2])   # 0.2: fewer than k = 100 pass
def test_retrieval_cand_matches_reference(models, p):
    jcfg, jparams, cfg, model = models
    batch, cand, mask = _retrieval_inputs(cfg, p)
    jstep = JARCH.step_fn(jcfg, "retrieval_cand", reduced=True)
    want_ids, want_s = jstep(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                             jnp.asarray(cand), jnp.asarray(mask))
    step = ARCH.step_fn(cfg, "retrieval_cand")
    before = filtered_topk_cuda.launches
    ids, s = step(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                  torch.from_numpy(cand), torch.from_numpy(mask))
    assert filtered_topk_cuda.launches == before   # CPU: the plain version
    assert ids.shape == (1, 100) and ids.dtype == torch.int32
    u = np.asarray(jrecsys.user_embed(jcfg, jparams, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    assert_ids_match(ids.numpy(), want_ids, s.numpy(), want_s, cand, u,
                     metric="ip")
    want_s = np.asarray(want_s)
    fin = np.isfinite(want_s)
    np.testing.assert_allclose(s.numpy()[fin], want_s[fin], atol=1e-5)
    np.testing.assert_array_equal(s.numpy()[~fin], want_s[~fin])
    assert (~fin).any() == (mask.sum() < 100)


@pytest.mark.parametrize("p", [0.5, 0.2])   # 0.2: fewer than k = 100 pass
def test_filtered_retrieval_step_matches_reference(models, p):
    """The mesh-explicit step on a one-device mesh (``make_host_mesh()``
    without a process group) against the reference's on
    ``jax.make_mesh((1, 1))``: ids identical except at near ties, scores
    within 1e-5; a masked candidate keeps its id beside a -inf score, as
    in the reference."""
    from repro.configs.two_tower_retrieval import (
        filtered_retrieval_step as ref_step)
    from repro_torch.launch.mesh import make_host_mesh
    jcfg, jparams, cfg, model = models
    batch, cand, mask = _retrieval_inputs(cfg, p)
    want_ids, want_s = ref_step(jax.make_mesh((1, 1), ("data", "model")),
                                jcfg)(jparams, {k: jnp.asarray(v)
                                                for k, v in batch.items()},
                                      jnp.asarray(cand), jnp.asarray(mask))
    step = ARCH.step_fn(cfg, "retrieval_cand", mesh=make_host_mesh())
    ids, s = step(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                  torch.from_numpy(cand), torch.from_numpy(mask), 0)
    assert ids.shape == (1, 100) and ids.dtype == torch.int32
    want_s = np.asarray(want_s)
    fin = np.isfinite(want_s)
    u = np.asarray(jrecsys.user_embed(jcfg, jparams, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    keep = lambda a: np.where(fin, a, -1)  # noqa: E731  (padding aside)
    assert_ids_match(keep(ids.numpy()), keep(np.asarray(want_ids)),
                     s.numpy(), want_s, cand, u, metric="ip")
    np.testing.assert_array_equal(ids.numpy()[~fin],
                                  np.asarray(want_ids)[~fin])
    np.testing.assert_allclose(s.numpy()[fin], want_s[fin], atol=1e-5)
    assert (~fin).any() == (mask.sum() < 100)


def test_serve_p99_matches_reference(models):
    jcfg, jparams, cfg, model = models
    jb, tb = _batch(cfg, 8, seed=3)
    want = JARCH.step_fn(jcfg, "serve_p99", reduced=True)(jparams, jb)
    got = ARCH.step_fn(cfg, "serve_p99")(model, tb)
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _shape_dtype(spec):
    return tuple(spec.shape), str(spec.dtype).replace("torch.", "")


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_abstract_inputs_match_reference(shape, reduced):
    jcfg, cfg = JARCH.config(reduced=reduced), ARCH.config(reduced=reduced)
    want = JARCH.abstract_inputs(jcfg, shape, reduced=reduced)
    got = ARCH.abstract_inputs(cfg, shape, reduced=reduced)
    assert len(got) == len(want)
    assert param_count(got[0]) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want[0]))
    assert _shape_dtype(got[0]["user_emb"]) == (want[0]["user_emb"].shape,
                                                "float32")
    assert {k: _shape_dtype(v) for k, v in got[1].items()} == {
        k: (v.shape, np.dtype(v.dtype).name) for k, v in want[1].items()}
    for g, w in zip(got[2:], want[2:]):
        assert _shape_dtype(g) == (w.shape, np.dtype(w.dtype).name)


def test_cells_match_reference():
    assert [(c.shape, c.kind, c.skip) for c in ARCH.cells()] == [
        (c.shape, c.kind, c.skip) for c in JARCH.cells()]


def test_unported_kinds_and_arches_raise():
    # every two-tower kind is ported now (its train step is tested in
    # test_torch_train_steps.py); a loss exists for train cells only, and
    # every arch of the reference's registry is ported since item 5d
    cfg = ARCH.config(reduced=True)
    with pytest.raises(ValueError, match="not a train cell"):
        ARCH.loss_fn(cfg, "serve_p99")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_init_two_tower_law_and_seed():
    cfg = ARCH.config(reduced=True)
    a = init_two_tower(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = init_two_tower(cfg, torch.Generator().manual_seed(1), device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), name
        assert not pa.requires_grad
    assert abs(float(a.user_emb.std()) - 0.02) < 0.002
    w0 = a.user_tower[0].weight                  # (out, in)
    assert w0.shape == (cfg.tower_dims[0],
                        cfg.embed_dim * (1 + cfg.n_user_feats))
    assert abs(float(w0.std()) * w0.shape[1] ** 0.5 - 1.0) < 0.05
    assert all(float(lin.bias.abs().max()) == 0.0
               for lin in list(a.user_tower) + list(a.item_tower))
    assert param_count(a) == param_count(ARCH.abstract_params(cfg))
