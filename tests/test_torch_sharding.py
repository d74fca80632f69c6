"""The port's training mesh rules (``distributed/sharding.py``, every arch's
``in_shardings``) and its sharded steps, against the JAX reference.

Spec parity, in process: for every arch of the registry (``acorn`` among
them), every cell, both LM layouts and the FULL and REDUCED configs, on
the production meshes 16 x 16 (data, model) and 2 x 16 x 16 (pod, data,
model) and on (4, 2), (2, 4), (1, 8), (8, 1) and (2, 2, 2), the port's
``in_shardings`` on an ``AbstractMesh`` equals the reference's on a
stand-in mesh (its rules read only ``axis_names`` and ``devices.shape``),
entry for entry.  The parameters' specs are carried through
``convert.param_arrays``, the converter of the weights: each reference
spec rides on a never-read numpy view of its parameter's shape whose
strides name the leaf and the dim, so the converter's per-layer slicing
and transposes carry every entry onto the port's dim.

Placing and stepping, on spawned ``gloo`` groups of 4 and 8 ranks (meshes
(2, 2) and (2, 2, 2)): ``place`` / ``gather`` round-trip bit for bit and
cut the blocks ``Mesh.block`` names; ``sharded_step`` at REDUCED for qwen3
(``baseline``) and smollm (``pure_dp``) train, deepseek (MLA) decode,
moonshot (MoE) train, the four recsys arches' ``train_batch`` and PNA
``molecule`` and ``full_graph_sm``: every rank's blocks equal the plain
one-rank step's, cut by the same specs, bit for bit.  The LM train batch
is 8 rows (REDUCED has 4), so that ``pure_dp`` splits it over 8 ranks.

The ranks import this module, so it imports nothing of JAX at module
level.
"""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed.collectives import get_mesh
from repro_torch.distributed.sharding import (AbstractMesh, P, gather, place,
                                              sharded_step)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.optimizer import AdamWState, init_adamw
from torch_parity import run_ranks

DM, PDM = ("data", "model"), ("pod", "data", "model")
MESHES = [((16, 16), DM), ((2, 16, 16), PDM), ((4, 2), DM), ((2, 4), DM),
          ((1, 8), DM), ((8, 1), DM), ((2, 2, 2), PDM)]
CELLS = [(a, c.shape) for a in ARCH_IDS for c in get_arch(a).cells()]


def _config(arch_id, reduced, shape):
    arch = get_arch(arch_id)
    return (arch.config(reduced=reduced, shape=shape) if arch_id == "pna"
            else arch.config(reduced=reduced))


# ---------------------------------------------------------------------------
# spec parity
# ---------------------------------------------------------------------------


def _memo(fn):
    cache = {}

    def wrapped(cfg):
        key = repr(cfg)
        if key not in cache:
            cache[key] = fn(cfg)
        return cache[key]
    return wrapped


@pytest.fixture(scope="module")
def reference():
    """The reference's arch objects, each ``abstract_params`` (and the
    port's) memoized for the module: the rules are pure, the abstract
    trees the slow part."""
    from repro.configs import get_arch as jax_get_arch
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for a in ARCH_IDS:
            for arch in (jax_get_arch(a), get_arch(a)):
                if hasattr(arch, "abstract_params"):
                    mp.setattr(arch, "abstract_params",
                               _memo(arch.abstract_params))
            out[a] = jax_get_arch(a)
        yield out


def _tagged(shape, leaf: int):
    """A numpy view of ``shape`` that is never read: dim i of leaf ``leaf``
    has a stride of ``leaf * 8 + i + 1`` bytes (parameters have < 8
    dims), so after the converter's slicing and transposes the strides say
    which leaf and which of its dims each port dim is."""
    return np.lib.stride_tricks.as_strided(
        np.zeros(1, np.int8), shape=tuple(shape),
        strides=tuple(leaf * 8 + i + 1 for i in range(len(shape))),
        writeable=False)


def _carry(ref_specs, ref_params, model) -> dict:
    """The reference's parameter spec tree as ``{port name: spec tuple}``,
    carried through ``convert.param_arrays`` (each spec padded with
    ``None`` to its parameter's dims)."""
    import jax
    from jax.sharding import PartitionSpec
    from repro_torch.convert import param_arrays
    specs = jax.tree_util.tree_leaves(
        ref_specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    leaves, treedef = jax.tree_util.tree_flatten(ref_params)
    assert len(specs) == len(leaves)
    tree = jax.tree_util.tree_unflatten(
        treedef, [_tagged(x.shape, i) for i, x in enumerate(leaves)])
    out = {}
    for name, view in param_arrays(tree, model).items():
        (leaf,) = {(s - 1) // 8 for s in view.strides}
        spec = _pad(specs[leaf], len(leaves[leaf].shape))
        out[name] = tuple(spec[(s - 1) % 8] for s in view.strides)
    return out


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


def _assert_specs(port, ref, ref_params, model, path=""):
    """Port specs against the reference's, walked together: a dict keyed
    by the model's parameter names is held to the carried tree, a spec to
    the reference's entry for entry, containers key by key."""
    names = {k: p.shape for k, p in model.named_parameters()} \
        if model is not None else {}
    if isinstance(port, dict) and names and set(port) == set(names):
        got = {k: _pad(v, len(names[k])) for k, v in port.items()}
        want = _carry(ref, ref_params, model)
        bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        assert not bad, f"{path}: port vs reference {bad}"
    elif isinstance(port, P):
        assert tuple(port) == tuple(ref), f"{path}: {port} vs {ref}"
    elif isinstance(port, dict):
        assert set(port) == set(ref), f"{path}: {sorted(port)}"
        for k in port:
            _assert_specs(port[k], ref[k], ref_params, model, f"{path}.{k}")
    else:
        assert isinstance(port, tuple) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_specs(a, b, ref_params, model, f"{path}.{i}")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_in_shardings_equal_reference(reference, arch_id, shape, reduced):
    arch, jarch = get_arch(arch_id), reference[arch_id]
    cfg = _config(arch_id, reduced, shape)
    jcfg = (jarch.config(reduced=reduced, shape=shape) if arch_id == "pna"
            else jarch.config(reduced=reduced))
    model = arch.module(cfg) if cfg is not None else None
    ref_params = jarch.abstract_params(jcfg) if cfg is not None else None
    layouts = ("baseline", "pure_dp") if arch.family == "lm" else (None,)
    for mesh_shape, axes in MESHES:
        stand_in = types.SimpleNamespace(
            axis_names=axes, devices=np.empty(mesh_shape, object))
        for layout in layouts:
            kw = {} if layout is None else {"layout": layout}
            _assert_specs(
                arch.in_shardings(cfg, shape, AbstractMesh(mesh_shape, axes),
                                  **kw),
                jarch.in_shardings(jcfg, shape, stand_in, **kw),
                ref_params, model, f"{arch_id}/{shape}/{mesh_shape}/{layout}")


def test_carry_detects_a_rule_on_the_port_layout():
    """The carried comparison is not vacuous: a tower weight's spec decided
    on the port's (out, in) shape, as if no layout were given, differs."""
    from repro_torch.configs.recsys_common import recsys_param_spec_tree
    arch = get_arch("two-tower-retrieval")
    mesh = AbstractMesh((16, 16), DM)
    good = arch.in_shardings(arch.config(), "train_batch", mesh)[0]
    naive = recsys_param_spec_tree(arch.abstract_params(arch.config()), mesh)
    assert good["user_tower.0.weight"] == P("model", None)
    assert naive["user_tower.0.weight"] != good["user_tower.0.weight"]
    assert good["user_emb"] == naive["user_emb"] == P("model", None)


def test_spec_pickles_and_prints():
    import pickle
    spec = P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert type(pickle.loads(pickle.dumps(spec))) is P
    assert repr(spec) == "P(('pod', 'data'), None, 'model')" and P() == ()


@pytest.mark.parametrize("shape,axes", [((16, 16), DM), ((2, 16, 16), PDM)])
def test_activation_specs_and_named_equal_reference(shape, axes):
    from jax.sharding import PartitionSpec
    from repro.distributed import sharding as ref
    from repro_torch.distributed.sharding import (NamedSharding, batch_spec,
                                                  named, replicated)
    mesh = AbstractMesh(shape, axes)
    stand_in = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape, object))
    for extra in (0, 1, 3):
        assert tuple(batch_spec(mesh, extra)) == tuple(
            ref.batch_spec(stand_in, extra))
        assert tuple(replicated(mesh, extra)) == tuple(
            ref.replicated(stand_in, extra))
    tree = {"a": P("model", None), "b": (P(), None)}
    got = named(mesh, tree)
    assert isinstance(got["a"], NamedSharding) and got["a"].mesh is mesh
    assert got["a"].spec == P("model", None) and got["b"][0].spec == P()
    assert got["b"][1].spec is None
    assert isinstance(ref.batch_spec(stand_in), PartitionSpec)


def test_one_rank_mesh_moves_nothing():
    """On a one-device mesh ``place`` and ``sharded_step`` copy nothing:
    the step runs on the caller's tensors and updates them in place."""
    arch = get_arch("qwen3-8b")
    cfg = arch.config(reduced=True)
    mesh = make_host_mesh()
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_adamw(model)
    ptrs = {k: p.data_ptr() for k, p in model.named_parameters()}
    tok = torch.randint(0, cfg.vocab, (4, 9), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    specs = arch.in_shardings(cfg, "train_4k", mesh)
    args = place((model, opt, batch), specs, mesh)
    assert args[0] is model and args[1].mu["embed"] is opt.mu["embed"]
    before = model.embed.detach().clone()
    m2, o2, loss = sharded_step(arch.step_fn(cfg, "train_4k"), mesh,
                                specs)(*args)
    assert m2 is model and o2.mu["embed"] is opt.mu["embed"]
    assert {k: p.data_ptr() for k, p in model.named_parameters()} == ptrs
    assert not torch.equal(model.embed, before) and loss.dim() == 0


def test_place_rejects_an_abstract_mesh_and_uneven_splits():
    with pytest.raises(TypeError, match="Mesh of ranks"):
        place(torch.zeros(4), P("data"), AbstractMesh((2,), ("data",)))
    with pytest.raises(ValueError, match="more entries"):
        place(torch.zeros(4), P(None, None), make_host_mesh())


# ---------------------------------------------------------------------------
# placing and stepping on gloo ranks
# ---------------------------------------------------------------------------

STEP_CASES = [
    ("qwen3-8b", "train_4k", "baseline"),
    ("smollm-360m", "train_4k", "pure_dp"),
    ("deepseek-v2-lite-16b", "decode_32k", "baseline"),
    ("moonshot-v1-16b-a3b", "train_4k", "baseline"),
    ("two-tower-retrieval", "train_batch", None),
    ("dien", "train_batch", None),
    ("sasrec", "train_batch", None),
    ("dcn-v2", "train_batch", None),
    ("pna", "molecule", None),
    ("pna", "full_graph_sm", None),
]
RANK_MESHES = {4: ((2, 2), DM), 8: ((2, 2, 2), PDM)}
LM_TRAIN_BATCH = 8


def _smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state(arch_id, shape, cfg, smoke):
    """A fresh (step arguments) of the case, the same on every call and
    every rank: weights from a seeded generator, the batch from numpy
    seeds."""
    cpu = torch.device("cpu")
    arch = get_arch(arch_id)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    if arch.family == "lm":
        if shape == "decode_32k":
            from repro_torch.models.transformer import init_cache
            gen = torch.Generator().manual_seed(2)
            cache = init_cache(cfg, 4, 32, device="cpu")
            for c in cache:
                c.normal_(generator=gen)
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1),
                                                dtype=np.int32))
            return (model, cache, {"tokens": tok,
                                   "pos": torch.tensor(20, dtype=torch.int32)})
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_TRAIN_BATCH, 17),
                                            dtype=np.int32))
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    elif arch_id == "two-tower-retrieval":
        batch = {k: torch.from_numpy(v)
                 for k, v in smoke.zipf_batch(cfg, 32, seed=1).items()}
    elif arch_id == "pna" and shape == "molecule":
        adj, feats = smoke.molecule_graphs(4, 12, cfg.d_in, seed=1)
        batch = {"feats": torch.from_numpy(feats),
                 "adj": torch.from_numpy(adj),
                 "labels": torch.from_numpy(rng.integers(
                     0, cfg.n_classes, 4, dtype=np.int32))}
    elif arch_id == "pna":
        from repro_torch.configs.pna import REDUCED_SHAPES
        spec = REDUCED_SHAPES[shape]
        batch, _, _ = smoke.sparse_batch(
            cpu, spec["n_nodes"], spec["n_edges"], spec["d_feat"],
            spec["classes"], seed=1,
            **smoke.SPARSE_GRAPHS[True][shape])
    else:
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 smoke.recsys_traffic(arch_id, cfg, seed=1)(32,
                                                            "train").items()}
    return (model, init_adamw(model), batch)


def _step_case(arch_id, shape, layout, mesh, smoke) -> dict:
    """The case's plain step on whole arguments, cut by the specs, against
    ``sharded_step`` on this rank's blocks: the tensors compared and how
    many of them the mesh splits."""
    arch = get_arch(arch_id)
    cfg = _config(arch_id, True, shape)
    step = (arch.step_fn(cfg, shape, reduced=True) if arch_id == "pna"
            else arch.step_fn(cfg, shape))
    specs = (arch.in_shardings(cfg, shape, mesh, layout) if layout
             else arch.in_shardings(cfg, shape, mesh))
    plain = step(*_state(arch_id, shape, cfg, smoke))
    if arch.family == "lm" and shape == "decode_32k":
        out_specs = (P(), specs[1])
    else:
        out_specs = (specs[0], specs[1], P())
    whole = {k: tuple(t.shape) for k, t in smoke.flat_outputs(plain).items()}
    want = smoke.flat_outputs(place(plain, out_specs, mesh))
    got = smoke.flat_outputs(sharded_step(step, mesh, specs)(*place(
        _state(arch_id, shape, cfg, smoke), specs, mesh)))
    smoke.assert_bits_equal(got, want, f"{arch_id} {shape}")
    return dict(tensors=len(want),
                split=sum(tuple(t.shape) != whole[k]
                          for k, t in want.items()))


def _round_trip(mesh, smoke) -> dict:
    """``place`` then ``gather`` of a tree holding every kind of spec,
    against blocks cut here by row-major coordinates."""
    g = torch.Generator().manual_seed(3)
    dp = tuple(a for a in mesh.axis_names if a != "model")
    dp = dp if len(dp) > 1 else dp[0]
    axes = tuple(mesh.axis_names)
    tree = (torch.randn((8, 6), generator=g),
            {"b": torch.randn((4, 16, 2), generator=g),
             "c": torch.randint(0, 9, (5,), generator=g, dtype=torch.int32),
             "d": torch.randn((), generator=g)},
            AdamWState(step=torch.tensor(3), mu={"m": torch.randn(
                (2, 8), generator=g)}, nu={"m": torch.randn((2, 8),
                                                            generator=g)}))
    specs = (P(dp, "model"), {"b": P(None, axes), "c": P(None), "d": P()},
             AdamWState(step=P(), mu={"m": P(None, "model")},
                        nu={"m": P(None, axes)}))
    blocks = place(tree, specs, mesh)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    coord = dict(zip(mesh.axis_names, mesh.coordinate))

    def cut(t, dim, names):
        names = (names,) if isinstance(names, str) else names
        i = int(np.ravel_multi_index([coord[a] for a in names],
                                     [sizes[a] for a in names]))
        return t.chunk(int(np.prod([sizes[a] for a in names])), dim)[i]

    want = (cut(cut(tree[0], 0, dp), 1, "model"),
            {"b": cut(tree[1]["b"], 1, axes), "c": tree[1]["c"],
             "d": tree[1]["d"]},
            AdamWState(step=tree[2].step,
                       mu={"m": cut(tree[2].mu["m"], 1, "model")},
                       nu={"m": cut(tree[2].nu["m"], 1, axes)}))
    assert type(blocks[2]) is AdamWState
    smoke.assert_bits_equal(smoke.flat_outputs(blocks),
                            smoke.flat_outputs(want), "blocks")
    smoke.assert_bits_equal(smoke.flat_outputs(gather(blocks, specs, mesh)),
                            smoke.flat_outputs(tree), "round trip")
    # a module's parameters take their blocks, and come back whole
    arch = get_arch("qwen3-8b")
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    orig = {k: p.detach().clone() for k, p in model.named_parameters()}
    pspecs = arch.in_shardings(cfg, "train_4k", mesh)[0]
    place(model, pspecs, mesh)
    split = sum(p.shape != orig[k].shape for k, p in model.named_parameters())
    gather(model, pspecs, mesh)
    same = all(torch.equal(p, orig[k]) for k, p in model.named_parameters())
    return dict(split_params=split, module_round_trip=same)


def _refusals(mesh) -> dict:
    """``sharded_step`` on a tensor and a module split over every axis:
    whether a step that updates in place gives this rank its block,
    whether one that returns new tensors of the split shape (an update
    out of place, a copied module) raises, and whether a new tensor shaped
    as a split input of a batch dict (read only) comes back whole."""
    import copy
    axes = tuple(mesh.axis_names)
    x = torch.arange(16.0).reshape(8, 2)
    xs = (P(axes, None),)
    lin = torch.nn.Linear(2, 8)
    ls = ({"weight": P(axes, None), "bias": P(axes)},)

    def raises(step, arg, specs):
        try:
            sharded_step(step, mesh, specs)(*place(arg, specs, mesh))
        except ValueError as e:
            return "split input" in str(e)
        return False
    got = sharded_step(lambda t: t.add_(1), mesh, xs)(
        *place((x.clone(),), xs, mesh))
    bs = ({"x": xs[0]},)
    scores = sharded_step(lambda b: b["x"] + 1, mesh, bs)(
        *place(({"x": x.clone()},), bs, mesh))
    return dict(
        in_place=torch.equal(got, place(x + 1, xs[0], mesh)),
        out_of_place=raises(lambda t: t + 1, (x.clone(),), xs),
        copied_module=raises(copy.deepcopy, (lin,), ls),
        batch_read=torch.equal(scores, x + 1))


def _mesh_rank(rank, world, shape, names):
    torch.manual_seed(0)
    mesh = get_mesh(shape, names)
    smoke = _smoke()
    out = {"round_trip": _round_trip(mesh, smoke),
           "refusals": _refusals(mesh)}
    for arch_id, cell, layout in STEP_CASES:
        out[f"{arch_id}/{cell}"] = _step_case(arch_id, cell, layout, mesh,
                                              smoke)
    return out


@pytest.fixture(scope="module", params=sorted(RANK_MESHES))
def rank_results(request, tmp_path_factory):
    shape, names = RANK_MESHES[request.param]
    return request.param, run_ranks(
        _mesh_rank, request.param, tmp_path_factory.mktemp("ranks"), shape,
        names)


def test_place_gather_round_trip(rank_results):
    world, results = rank_results
    for r in results:
        assert r["round_trip"] == dict(split_params=r["round_trip"][
            "split_params"], module_round_trip=True)
        assert r["round_trip"]["split_params"] > 0


def test_sharded_step_refuses_updates_out_of_place(rank_results):
    """An output's cut is known by identity only, so a new tensor (or a
    copied module's parameter) shaped as a split input raises rather
    than come back whole; an update in place comes back cut.  A batch
    dict is only read: a new tensor shaped as one of its split inputs
    (a serve step's scores) comes back whole."""
    world, results = rank_results
    for r in results:
        assert r["refusals"] == dict(in_place=True, out_of_place=True,
                                     copied_module=True, batch_read=True)


@pytest.mark.parametrize("arch_id,shape,layout", STEP_CASES)
def test_sharded_step_equals_plain_blocks(rank_results, arch_id, shape,
                                          layout):
    """Every rank's blocks equal the plain step's, cut by the same specs
    (checked in the ranks, bit for bit); the mesh splits some output of each case but PNA's and
    ``pure_dp``'s (their parameters replicate, their batch splits)."""
    world, results = rank_results
    for r in results:
        rec = r[f"{arch_id}/{shape}"]
        assert rec["tensors"] > 0
        if arch_id != "pna" and layout != "pure_dp":
            assert rec["split"] > 0, rec
