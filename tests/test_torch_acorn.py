"""The port's ``acorn`` serving arch and the two-tower mesh retrieval step
against the JAX reference.

In-process: cells, abstract inputs, ``in_shardings``, ``random_inputs``,
and both step variants at the REDUCED shapes on a one-device mesh
(``make_host_mesh()`` without a process group), held to the reference's
step on ``jax.make_mesh((1, 1), ("data", "model"))``; exact ties, where
ids must come out lower index first.  Spawned ``gloo`` groups of 2 and 4
ranks: the same steps on every ``(data, model)`` factorisation of the
world (each rank passes its row block), with the two-tower
``filtered_retrieval_step`` beside them, and the tie case on a mesh of
half the world, whose other ranks place empty blocks with base 0 and take
the mesh's answer.  Every rank must return identical arrays.  Tolerance: ids identical except at near ties, distances within
rtol 1e-5 / atol 1e-6 of |q|^2 + |x|^2 (the expanded form,
``torch_parity.assert_ids_match``); on integer data (exact fp32 scores)
ids and distances bit for bit.

The ranks import this module, so it imports nothing of JAX at module
level.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.acorn import REDUCED_ACORN_SHAPES
from repro_torch.convert import two_tower_params_from_arrays
from repro_torch.distributed.collectives import get_mesh
from repro_torch.distributed.sharding import P, place
from repro_torch.launch.mesh import (dp_axes, make_corpus_serving_mesh,
                                     make_host_mesh, make_production_mesh)
from torch_parity import assert_ids_match, assert_ranks_equal, run_ranks

ARCH = get_arch("acorn")


def inputs(shape, seed=0, ties=False):
    """numpy (x, queries, masks) of a REDUCED cell; ``ties``: small
    integers with repeated rows, so scores tie exactly."""
    spec = REDUCED_ACORN_SHAPES[shape]
    rng = np.random.default_rng(seed)
    b, n, d = spec["batch"], spec["n"], spec["d"]
    if ties:
        base = rng.integers(-2, 3, size=(n // 8, d)).astype(np.float32)
        x = base[rng.integers(0, n // 8, size=n)]
        q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    masks = rng.random((b, n)) < 0.5
    masks[0, 20:] = False            # fewer passing rows than k
    return x, q, masks


def ref_step(shape, x, q, masks, optimized, chunk):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step = jax_get_arch("acorn").step_fn(None, shape, reduced=True, mesh=mesh,
                                         optimized=optimized, chunk=chunk)
    ids, d = step(jnp.asarray(x), jnp.asarray(q), jnp.asarray(masks))
    return np.asarray(ids), np.asarray(d)


def port_step(mesh, shape, x, q, masks, optimized, chunk):
    step = ARCH.step_fn(None, shape, reduced=True, mesh=mesh,
                        optimized=optimized, chunk=chunk)
    ids, d = step(*ARCH.place_inputs(shape, mesh, torch.as_tensor(x),
                                     torch.as_tensor(q),
                                     torch.as_tensor(masks)))
    return ids.numpy(), d.numpy()


# (shape, optimized, chunk): the chunked scan over several blocks, and a
# chunk that leaves a tail the reference's scan does not reach
VARIANTS = [("serve_1m", False, 8192), ("serve_1m", True, 8192),
            ("serve_1m", True, 512), ("serve_25m", True, 1000),
            ("serve_25m", False, 8192)]


def test_cells_and_abstract_inputs_match_reference():
    from repro.configs import get_arch as jax_get_arch
    jarch = jax_get_arch("acorn")
    assert [(c.shape, c.kind) for c in ARCH.cells()] == [
        (c.shape, c.kind) for c in jarch.cells()]
    for shape in ("serve_1m", "serve_25m"):
        for reduced in (False, True):
            got = ARCH.abstract_inputs(None, shape, reduced=reduced)
            want = jarch.abstract_inputs(None, shape, reduced=reduced)
            assert [g.shape for g in got] == [w.shape for w in want]
            assert [str(g.dtype).split(".")[-1] for g in got] == [
                np.dtype(w.dtype).name for w in want]


def test_meshes_without_a_process_group():
    mesh = make_host_mesh()
    assert (mesh.shape, mesh.axis_names) == ((1, 1), ("data", "model"))
    assert mesh.coordinate == (0, 0) and dp_axes(mesh) == ("data",)
    assert make_corpus_serving_mesh(1, 1).axis_names == ("data", "corpus")
    with pytest.raises(ValueError, match="process group"):
        make_corpus_serving_mesh(2, 1)
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="mesh-explicit"):
        ARCH.step_fn(None, "serve_1m", reduced=True)


@pytest.mark.parametrize("shape,optimized,chunk", VARIANTS)
def test_step_matches_reference(shape, optimized, chunk):
    x, q, masks = inputs(shape)
    ids, d = port_step(make_host_mesh(), shape, x, q, masks, optimized,
                       chunk)
    want_ids, want_d = ref_step(shape, x, q, masks, optimized, chunk)
    assert ids.dtype == np.int32 and d.dtype == np.float32
    assert_ids_match(ids, want_ids, d, want_d, x, q, expanded=True)
    assert (ids[0, :10] >= 0).sum() == masks[0].sum() == (
        want_ids[0] >= 0).sum()
    passing = np.take_along_axis(masks, np.maximum(ids, 0), axis=1)
    assert (passing | (ids < 0)).all()


@pytest.mark.parametrize("optimized,chunk", [(False, 8192), (True, 256)])
def test_exact_ties_lower_index_first(optimized, chunk):
    x, q, masks = inputs("serve_1m", seed=3, ties=True)
    ids, d = port_step(make_host_mesh(), "serve_1m", x, q, masks, optimized,
                       chunk)
    want_ids, want_d = ref_step("serve_1m", x, q, masks, optimized, chunk)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(d, want_d)
    # ties really happen, and fall to the lower index
    tied = d[:, 1:] == d[:, :-1]
    assert tied.any()
    assert (ids[:, 1:][tied] > ids[:, :-1][tied]).all()


def test_in_shardings_and_random_inputs():
    mesh = make_host_mesh()
    x, q, m = ARCH.random_inputs("serve_1m", seed=5, reduced=True,
                                 device="cpu")
    spec = REDUCED_ACORN_SHAPES["serve_1m"]
    assert x.shape == (spec["n"], spec["d"]) and x.dtype == torch.float32
    assert m.shape == (spec["batch"], spec["n"]) and m.dtype == torch.bool
    assert abs(float(m.float().mean()) - 0.5) < 0.02
    x2, _, m2 = ARCH.random_inputs("serve_1m", seed=5, reduced=True,
                                   device="cpu")
    assert torch.equal(x, x2) and torch.equal(m, m2)
    specs = ARCH.in_shardings(None, "serve_1m", mesh)
    assert specs == (P(("data", "model"), None), P(), P(None,
                                                         ("data", "model")))
    xl, ql, ml = place((x, q, m), specs, mesh)
    assert xl is x and ml is m and ql is q          # one rank: no copy
    assert ARCH.place_inputs("serve_1m", mesh, x, q, m)[3] == 0


def gather_order(n, dp, tp):
    """Rows of a length-``n`` dim split over a (dp, tp) ("data", "model")
    mesh, in the order the reference's candidates arrive: it gathers along
    "data", then "model", so block (d, m) = d * tp + m comes m-major, d
    minor, and equal scores fall to the earlier arrival.  Its 1 x 1 step
    over rows laid out in this order, ids mapped back, is its answer on
    that mesh."""
    nb = n // (dp * tp)
    return np.concatenate([np.arange(b * nb, (b + 1) * nb) for b in
                           (d * tp + m for m in range(tp)
                            for d in range(dp))])


@pytest.fixture(scope="module")
def two_tower():
    """The reference's REDUCED two-tower parameters (numpy), a batch,
    candidates and masks, and its step on a one-device mesh for rows laid
    out in a given order."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.two_tower_retrieval import (
        filtered_retrieval_step as ref_step_fn)
    jarch = jax_get_arch("two-tower-retrieval")
    jcfg = jarch.config(reduced=True)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jarch.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    b, n = 2, 256
    batch = dict(user_id=np.array([3, 700], np.int32),
                 user_feats=rng.integers(0, jcfg.n_users, size=(b, 2))
                 .astype(np.int32),
                 item_id=np.zeros(b, np.int32), logq=np.zeros(b, np.float32))
    cand = rng.normal(size=(n, jcfg.tower_dims[-1])).astype(np.float32)
    mask = rng.random((b, n)) < 0.3
    mask[1, 40:] = False                      # fewer than k pass

    def want(order=np.arange(n)):
        ids, s = ref_step_fn(jax.make_mesh((1, 1), ("data", "model")), jcfg)(
            jax.tree_util.tree_map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(cand[order]), jnp.asarray(mask[:, order]))
        return order[np.asarray(ids)], np.asarray(s)

    from repro.models import recsys as jrecsys
    u = np.asarray(jrecsys.user_embed(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    return tree, batch, cand, mask, want, u


def two_tower_step(mesh, tree, batch, cand, mask):
    cfg = get_arch("two-tower-retrieval").config(reduced=True)
    model = two_tower_params_from_arrays(tree, cfg, device="cpu")
    step = get_arch("two-tower-retrieval").step_fn(cfg, "retrieval_cand",
                                                   mesh=mesh)
    rows = mesh.block(cand.shape[0], tuple(mesh.axis_names))
    ids, s = step(model, {k: torch.as_tensor(v) for k, v in batch.items()},
                  torch.as_tensor(cand[rows]),
                  torch.as_tensor(mask[:, rows]), rows.start)
    return ids.numpy(), s.numpy()


def assert_two_tower(got, want, cand, u):
    """Scores within 1e-5 and the same -inf padding; among the finite
    scores, ids identical except at near ties of the inner product of the
    user embedding ``u`` with ``cand`` (``torch_parity.assert_ids_match``);
    ids identical where the score is -inf (masked ids kept, as the
    reference keeps them)."""
    ids, s = got
    w_ids, w_s = want
    fin = np.isfinite(w_s)
    assert np.array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], w_s[fin], rtol=1e-5, atol=1e-5)
    assert_ids_match(np.where(fin, ids, -1), np.where(fin, w_ids, -1), s, w_s,
                     cand, u, metric="ip")
    assert np.array_equal(ids[~fin], w_ids[~fin])


def test_two_tower_mesh_step_matches_reference(two_tower):
    tree, batch, cand, mask, want, u = two_tower
    got = two_tower_step(make_host_mesh(), tree, batch, cand, mask)
    assert got[0].shape == (2, 100) and got[0].dtype == np.int32
    assert_two_tower(got, want(), cand, u)


def _mesh_rank(rank, world, cases, tt):
    """The acorn step (each case, on every (data, model) factorisation of
    the world) and the two-tower mesh step, each rank on its blocks."""
    out = {}
    for tp in [v for v in (1, 2, 4) if world % v == 0]:
        mesh = make_host_mesh(tp)
        for name, (shape, x, q, masks, optimized, chunk) in cases.items():
            out[f"{name}/{tp}"] = port_step(mesh, shape, x, q, masks,
                                            optimized, chunk)
        out[f"two_tower/{tp}"] = two_tower_step(mesh, *tt)
    # a mesh of half the world: the other ranks are outside it, place
    # empty blocks with base 0 and take the mesh's answer
    sub = get_mesh((world // 2, 1), ("data", "model"))
    shape, x, q, masks, optimized, chunk = cases["ties"]
    out["ties/sub"] = port_step(sub, shape, x, q, masks, optimized, chunk)
    xl, _, ml, base = ARCH.place_inputs(shape, sub, torch.as_tensor(x),
                                        torch.as_tensor(q),
                                        torch.as_tensor(masks))
    return {"steps": out, "placed": (xl.shape[0], ml.shape[1], base)}


@pytest.mark.parametrize("world", [2, 4])
def test_steps_on_gloo_meshes(world, two_tower, tmp_path):
    tree, batch, cand, mask, want_tt, u = two_tower
    cases = {}
    for shape, optimized, chunk in VARIANTS[:3]:
        cases[f"{shape}/{optimized}/{chunk}"] = (
            shape, *inputs(shape), optimized, chunk)
    x, q, masks = inputs("serve_1m", seed=3, ties=True)
    cases["ties"] = ("serve_1m", x, q, masks, True, 256)
    got = run_ranks(_mesh_rank, world, tmp_path, cases,
                    (tree, batch, cand, mask))
    n = x.shape[0]
    for r, res in enumerate(got):        # ranks >= world // 2: outside
        rows = n // (world // 2) if r < world // 2 else 0
        assert res["placed"] == (rows, rows, r * rows), (r, res["placed"])
    got = [res["steps"] for res in got]
    assert_ranks_equal(got)
    for key, (ids, d) in got[0].items():
        name, tp = key.rsplit("/", 1)
        dp, tp = (world // 2, 1) if tp == "sub" else (world // int(tp),
                                                      int(tp))
        if name == "two_tower":
            assert_two_tower((ids, d), want_tt(
                gather_order(cand.shape[0], dp, tp)), cand, u)
            continue
        shape, x, q, masks, optimized, chunk = cases[name]
        order = gather_order(x.shape[0], dp, tp)
        want_ids, want_d = ref_step(shape, x[order], q, masks[:, order],
                                    optimized, chunk)
        want_ids = np.where(want_ids >= 0, order[np.maximum(want_ids, 0)],
                            -1)
        if name == "ties":
            np.testing.assert_array_equal(ids, want_ids, err_msg=key)
            np.testing.assert_array_equal(d, want_d, err_msg=key)
        else:
            assert_ids_match(ids, want_ids, d, want_d, x, q, expanded=True)


# ---- a bf16 corpus, as the reference's perf variants pass it -------------

def perf_inputs():
    """The reference perf test's inputs (``tests/test_perf_variants.py``):
    n 4,096, d 32, B 8, masks at 0.4, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    n, d, b = 4096, 32, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    return x, q, rng.random((b, n)) < 0.4


def bf16_steps(x, q, masks, optimized, chunk=256):
    """(port, reference) (ids, dists) of the step over ``x`` cast to bf16,
    each on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    step = jax_get_arch("acorn").step_fn(
        None, "serve_1m", mesh=jax.make_mesh((1, 1), ("data", "model")),
        optimized=optimized, chunk=chunk)
    ids, d = step(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q),
                  jnp.asarray(masks))
    mesh = make_host_mesh()
    port = ARCH.step_fn(None, "serve_1m", mesh=mesh, optimized=optimized,
                        chunk=chunk)
    pi, pd = port(*ARCH.place_inputs(
        "serve_1m", mesh, torch.as_tensor(x).to(torch.bfloat16),
        torch.as_tensor(q), torch.as_tensor(masks)))
    return (pi.numpy(), pd.numpy()), (np.asarray(ids), np.asarray(d))


def overlap(a, b):
    return np.mean([len(set(u) & set(v)) / a.shape[1] for u, v in zip(a, b)])


def test_perf_inputs_fp32_optimized_matches_reference():
    """The fp32 corpus of the same inputs: ids identical, dists within
    1e-3 (the reference perf test's bounds)."""
    x, q, masks = perf_inputs()
    ids, d = port_step(make_host_mesh(), "serve_1m", x, q, masks, True, 256)
    want_ids, want_d = ref_step("serve_1m", x, q, masks, True, 256)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(d, want_d, atol=1e-3, rtol=0)


def test_bf16_corpus_optimized_against_fp32_and_reference():
    """The chunked scan over a bf16 corpus runs (it raised before) and
    ranks as the reference does.  Against the port's own fp32 ids the top
    10 overlap >= 0.9, the reference test's bound.  Against the
    reference's bf16 ids they overlap >= 0.99, and every differing slot is
    a near tie at bf16's rounding of the product: the port rounds the
    bf16 x bf16 product to bf16 before the fp32 upcast, the reference's
    fused upcast may keep it, so two rows may swap where their float64
    scores (of the bf16 values) differ by at most 2^-7 (|q.x_a| +
    |q.x_b|)."""
    x, q, masks = perf_inputs()
    (ids, d), (want_ids, _) = bf16_steps(x, q, masks, optimized=True)
    assert ids.dtype == np.int32 and d.dtype == np.float32
    assert np.isfinite(d[ids >= 0]).all()
    fp32_ids, _ = port_step(make_host_mesh(), "serve_1m", x, q, masks, True,
                            256)
    assert overlap(ids, fp32_ids) >= 0.9
    assert overlap(ids, want_ids) >= 0.99
    xb = torch.as_tensor(x).to(torch.bfloat16).double().numpy()
    qb = torch.as_tensor(q).to(torch.bfloat16).double().numpy()
    for qi, j in zip(*np.nonzero(ids != want_ids)):
        a, b = ids[qi, j], want_ids[qi, j]
        pa, pb = qb[qi] @ xb[a], qb[qi] @ xb[b]
        sa, sb = 2 * pa - xb[a] @ xb[a], 2 * pb - xb[b] @ xb[b]
        assert abs(sa - sb) <= 2.0 ** -7 * (abs(pa) + abs(pb)), (qi, j)


def test_bf16_corpus_baseline_matches_reference():
    """The unchunked step over a bf16 corpus: both packages compute the
    product in fp32 (jnp promotes fp32 x bf16 to fp32) and sum the norms
    in bf16, so the fp32 tolerances hold over the bf16 values: ids
    identical except at near ties, dists within rtol 1e-5 / atol 1e-6 of
    |q|^2 + |x|^2."""
    x, q, masks = perf_inputs()
    (ids, d), (want_ids, want_d) = bf16_steps(x, q, masks, optimized=False)
    xb = torch.as_tensor(x).to(torch.bfloat16).float().numpy()
    assert_ids_match(ids, want_ids, d, want_d, xb, q, expanded=True)


def pre_repair_step(x, q, masks, optimized, chunk, k=10):
    """The one-device step's arithmetic as it was before the bf16 repair,
    op for op: its fp32 outputs must not move by a bit."""
    from repro_torch.distributed.collectives import top_k

    def scores(q, xb, mb):
        xn = (xb * xb).sum(dim=1)
        s = 2.0 * (q @ xb.T) - xn[None, :]
        return torch.where(mb, s, torch.full_like(s, float("-inf")))

    b, n = q.shape[0], x.shape[0]
    qn = (q * q).sum(dim=1, keepdim=True)
    if optimized:
        nc = max(n // chunk, 1)
        cs = n // nc
        bs = torch.full((b, k), float("-inf"))
        bi = torch.full((b, k), -1, dtype=torch.int64)
        for i in range(nc):
            rows = slice(i * cs, (i + 1) * cs)
            ts_c, tp_c = top_k(scores(q, x[rows], masks[:, rows]), k)
            ms = torch.cat([bs, ts_c], dim=1)
            mi = torch.cat([bi, tp_c + i * cs], dim=1)
            bs, tp = top_k(ms, k)
            bi = torch.gather(mi, 1, tp)
    else:
        bs, bi = top_k(scores(q, x, masks), k)
    s2, pos = top_k(bs, k)
    ids = torch.gather(bi.to(torch.int32), 1, pos)
    return torch.where(torch.isfinite(s2), ids, torch.full_like(ids, -1)), \
        qn - s2


@pytest.mark.parametrize("optimized,chunk", [(False, 8192), (True, 256),
                                             (True, 1000)])
def test_fp32_outputs_unchanged_by_the_bf16_repair(optimized, chunk):
    x, q, masks = (torch.as_tensor(a) for a in perf_inputs())
    mesh = make_host_mesh()
    ids, d = ARCH.step_fn(None, "serve_1m", mesh=mesh, optimized=optimized,
                          chunk=chunk)(*ARCH.place_inputs("serve_1m", mesh,
                                                          x, q, masks))
    want_ids, want_d = pre_repair_step(x, q, masks, optimized, chunk)
    assert torch.equal(ids, want_ids)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
