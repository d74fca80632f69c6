"""Per-architecture sharding rules (partition-spec trees), and placing and
running a step by them.

Scheme (MaxText-style 2-D weight sharding), the reference's:
  * the "output-feature" dim of big weights goes on the tensor axis
    ('model') when divisible — heads, d_ff, experts, vocab;
  * the other dim goes on the batch axes (FSDP-style);
  * anything indivisible stays replicated (e.g. smollm's 15 heads, qwen3's
    8 KV heads — attention weights then shard only along FSDP).

Every rule is decided on the reference's parameter name and shape, then
carried to the port's layout (``Layout``), as ``repro_torch.convert``
carries the weights: the LM's per-layer tensors are slices of the
reference's (L, ...) stacks (the leading ``None`` dropped), ``nn.Linear``
weights are the reference's (in, out) matrices transposed (the two entries
swapped).  No rule is re-derived on the port's shapes.

The rules read only axis names and sizes, so they take a :class:`Mesh` or
an :class:`AbstractMesh` (names and sizes, no ranks): the production
16 x 16 and 2 x 16 x 16 meshes reach them without 256 processes.

:func:`place`, :func:`gather` and :func:`sharded_step` run the rules on a
:class:`Mesh` whose ranks each hold one block of every tensor.  In this
version the step's compute is replicated: each argument is gathered whole
on every rank, the arch's own step runs unchanged, and updated inputs are
cut back to their blocks.  A rank's peak memory is the whole step plus its
blocks; a gather per layer and a tensor-parallel split of the compute are
later work.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .collectives import Mesh, all_gather_cat

Tensor = torch.Tensor


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one entry per
    leading dim, each ``None`` (replicated), an axis name, or a tuple of
    names (the dim split over those axes, row-major); dims past the last
    entry are replicated.  ``tuple(spec)`` equals the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class AbstractMesh:
    """Axis names and sizes with no ranks (jax's abstract mesh): what the
    spec rules read.  ``devices`` is an empty object array of the mesh's
    shape, as the rules of the reference read ``mesh.devices.shape``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or min(self.shape) < 1:
            raise ValueError(f"mesh shape {self.shape} / axes "
                             f"{self.axis_names}")
        self.devices = np.empty(self.shape, dtype=object)
        self.size = math.prod(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(zip(self.axis_names, self.shape))})"


# ---------------------------------------------------------------------------
# the rules, on the reference's names and shapes
# ---------------------------------------------------------------------------


def _div(n: int, k: int) -> bool:
    return n % k == 0 and n >= k


def _axis_sizes(mesh):
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    model = sizes.get("model", 1)
    data = sizes.get("data", 1) * sizes.get("pod", 1)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    return model, data, dp


def lm_param_spec(path: str, shape, mesh) -> P:
    """Map one LM parameter (by the reference's name + shape) to a spec."""
    model, data, dp = _axis_sizes(mesh)
    name = path.split("/")[-1]
    if name == "embed":                       # (V, D)
        v, d = shape
        return P("model" if _div(v, model) else None,
                 dp if _div(d, data) else None)
    if name in ("final_norm", "ln1", "ln2", "b", "q_norm", "k_norm"):
        return P(*([None] * len(shape)))
    if name in ("w_gate", "w_up", "ws_gate", "ws_up", "wq", "w_uk", "w_uv"):
        if len(shape) == 4:                   # (L, E, D, F) — experts
            return P(None, "model" if _div(shape[1], model) else None,
                     None, None)
        l, a, b = shape
        return P(None, dp if _div(a, data) else None,
                 "model" if _div(b, model) else None)
    if name in ("w_down", "ws_down", "wo"):
        if len(shape) == 4:                   # (L, E, F, D)
            return P(None, "model" if _div(shape[1], model) else None,
                     None, None)
        l, a, b = shape
        return P(None, "model" if _div(a, model) else None,
                 dp if _div(b, data) else None)
    if name in ("wk", "wv"):
        l, a, b = shape                       # shard KV out-dim only if clean
        return P(None, dp if _div(a, data) else None,
                 "model" if _div(b, model) else None)
    if name in ("router", "w_dkv"):
        l, a, b = shape
        return P(None, dp if _div(a, data) else None, None)
    # fallback: replicate
    return P(*([None] * len(shape)))


# ---------------------------------------------------------------------------
# layouts: a port parameter against the reference's
# ---------------------------------------------------------------------------

# (port name, port shape) -> (reference path, reference shape, carry), where
# carry maps the reference's spec onto the port's tensor
Layout = Callable[[str, Tuple[int, ...]], Tuple[str, Tuple[int, ...],
                                               Callable[[P], P]]]


def _same(spec: P) -> P:
    return spec


def _drop_layer(spec: P) -> P:
    return P(*spec[1:])


def _swap(spec: P) -> P:
    return P(*reversed(spec))


def same_layout(name: str, shape) -> tuple:
    """A parameter laid out as the reference's; its path is the dotted
    name with ``/`` (``tables.0`` -> ``tables/0``)."""
    return name.replace(".", "/"), tuple(shape), _same


def stacked_layout(n_layers: int) -> Layout:
    """The LM's: ``layers.{i}.{w}`` is slice i of the reference's
    ``layers/{w}`` stack of ``n_layers``; the rest as the reference's."""

    def layout(name: str, shape) -> tuple:
        parts = name.split(".")
        if parts[0] == "layers" and len(parts) == 3:
            return f"layers/{parts[2]}", (n_layers,) + tuple(shape), \
                _drop_layer
        return same_layout(name, shape)
    return layout


def linear_layout(*modules: str) -> Layout:
    """``nn.Linear`` stacks (two-tower's towers): ``{m}.{i}.weight`` (out,
    in) is the reference's ``{m}/w/{i}`` (in, out) transposed, and
    ``{m}.{i}.bias`` its ``{m}/b/{i}``; the rest as the reference's."""

    def layout(name: str, shape) -> tuple:
        parts = name.split(".")
        if parts[0] in modules and len(parts) == 3:
            if parts[2] == "weight":
                return (f"{parts[0]}/w/{parts[1]}", tuple(shape)[::-1],
                        _swap)
            return f"{parts[0]}/b/{parts[1]}", tuple(shape), _same
        return same_layout(name, shape)
    return layout


def tree_param_specs(params_shape: Mapping[str, Any], mesh,
                     rule=lm_param_spec, layout: Layout = same_layout
                     ) -> Dict[str, P]:
    """``{port parameter name: spec}`` of abstract parameters (anything
    with ``shape``: a ``TensorSpec``, a tensor): each spec decided by
    ``rule(reference path, reference shape, mesh)``, then carried to the
    port's layout."""
    specs = {}
    for name, leaf in params_shape.items():
        path, shape, carry = layout(name, tuple(leaf.shape))
        specs[name] = carry(rule(path, shape, mesh))
    return specs


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _is_spec(x) -> bool:
    return isinstance(x, P) or x is None


def _map_specs(fn, tree):
    """``fn`` over the spec leaves of a tree of dicts, tuples and
    named tuples."""
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    return type(tree)(_map_specs(fn, v) for v in tree)


def named(mesh, spec_tree):
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# common activation specs
# ---------------------------------------------------------------------------


def batch_spec(mesh, extra_dims: int = 1) -> P:
    """Batch sharded over all DP axes, everything else replicated."""
    _, _, dp = _axis_sizes(mesh)
    return P(dp, *([None] * extra_dims))


def replicated(mesh, ndims: int) -> P:
    return P(*([None] * ndims))


# ---------------------------------------------------------------------------
# placing, gathering and running a step on a mesh of ranks
# ---------------------------------------------------------------------------


def _slices(t: Tensor, spec, mesh: Mesh):
    """This rank's slice of each dim of ``t`` under ``spec`` (a rank
    outside the mesh: empty along every split dim)."""
    spec = tuple(spec or ())
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{t.dim()} dims")
    out = []
    for n, axes in zip(t.shape, spec):
        if axes is None:
            out.append(slice(None))
        elif mesh.coordinate is None:
            out.append(slice(0, 0))
        else:
            out.append(mesh.block(n, axes))
    return tuple(out)


def _block(t: Tensor, spec, mesh: Mesh) -> Tensor:
    """``t`` itself where the spec keeps it whole on this rank, else a
    contiguous copy of this rank's block."""
    sl = _slices(t, spec, mesh)
    if all(s == slice(None) or (s.start == 0 and s.stop == n)
           for s, n in zip(sl, t.shape)):
        return t
    return t[sl].clone(memory_format=torch.contiguous_format)


def _whole(t: Tensor, spec, mesh: Mesh) -> Tensor:
    """Undo :func:`_block`: all-gather each split dim over its axes (the
    innermost first, in :meth:`Mesh.axis_index` order); an axis of size 1
    moves nothing, so on a one-rank mesh ``t`` comes back as it is."""
    for dim, axes in enumerate(tuple(spec or ())):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in reversed(axes):
            if mesh.axis_size(a) > 1:
                t = all_gather_cat(t, mesh, a, dim)
    return t


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"placing needs a Mesh of ranks, not {mesh!r}")


def _walk(fn, tree, specs, module_fn):
    """``fn(tensor, spec)`` over the tensors of ``tree`` (dicts, tuples,
    named tuples, ``nn.Module``s), ``specs`` of the same structure with
    spec leaves (a module's: a dict by parameter name), or ``None`` for
    no specs at any depth; other leaves are kept.  A module goes to
    ``module_fn(module, specs)``."""
    if isinstance(tree, Tensor):
        return fn(tree, specs)
    if isinstance(tree, nn.Module):
        return module_fn(tree, specs)
    if isinstance(tree, Mapping):
        if specs is not None and set(tree) != set(specs):
            raise ValueError(f"specs keyed {sorted(specs)} for a tree keyed "
                             f"{sorted(tree)}")
        return {k: _walk(fn, v, None if specs is None else specs[k],
                         module_fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        if specs is None:
            specs = (None,) * len(tree)
        elif len(tree) != len(specs):
            raise ValueError(f"{len(specs)} specs for {len(tree)} entries")
        parts = [_walk(fn, v, s, module_fn) for v, s in zip(tree, specs)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return tree


def _module_fn(fn):
    def apply(module: nn.Module, specs: Mapping[str, P]) -> nn.Module:
        named_params = dict(module.named_parameters())
        if set(named_params) != set(specs):
            raise ValueError("the specs do not name the module's parameters")
        for name, p in named_params.items():
            p.data = fn(p.data, specs[name])
        return module
    return apply


def place(tree, specs, mesh: Mesh):
    """This rank's block of each tensor of ``tree`` under ``specs`` (the
    twin of ``jax.device_put(x, NamedSharding(mesh, spec))``): a dim whose
    entry names axes is cut by :meth:`Mesh.block` over them.  A tensor
    that stays whole comes back as it is (on a one-rank mesh nothing is
    copied); a block is a contiguous copy.  An ``nn.Module``'s parameters
    take their blocks in place (its specs: a dict by parameter name) and
    the module comes back."""
    _check_mesh(mesh)

    def fn(t, spec):
        return _block(t, spec, mesh)
    return _walk(fn, tree, specs, _module_fn(fn))


def gather(tree, specs, mesh: Mesh):
    """The whole tensors of blocks that :func:`place` cut: every rank of
    the mesh calls it with its blocks and gets the same whole tree back
    (a module's parameters made whole in place)."""
    _check_mesh(mesh)

    def fn(t, spec):
        return _whole(t, spec, mesh)
    return _walk(fn, tree, specs, _module_fn(fn))


def sharded_step(step: Callable, mesh: Mesh, in_specs: Sequence) -> Callable:
    """``run(*blocks)``: the twin of ``jax.jit(step, in_shardings=named(mesh,
    in_specs))``, called by every rank of ``mesh`` with its blocks of each
    argument (:func:`place`).

    Each argument is gathered whole (:func:`gather`) and ``step`` — the
    arch's own port step — runs unchanged on the whole arguments, so its
    compute is replicated over the ranks: a rank's peak is the whole step
    plus its blocks.  An output that is an updated input (the model, the
    optimizer state's moments, a cache written in place: the same module
    or tensor object) comes back cut by that input's spec, written into
    the rank's block in place; any other output comes back whole, the same
    on every rank.  An output's cut is known only by that identity, so a
    new tensor of the whole shape and dtype of a split input that a step
    may update (an input updated out of place would come back whole)
    raises ``ValueError``, as does an updated input whose block changed
    shape.  A step may update a module's parameters and the tensors of
    any argument but a dict of named inputs (a batch), which it only
    reads: a serve step's (B,) scores may be shaped as its batch's split
    (B,) ``logq``.  Input modules get their blocks back whatever the step
    returns.  On a one-rank mesh nothing is gathered or copied: ``step``
    runs on the very tensors it was given."""
    _check_mesh(mesh)
    in_specs = tuple(in_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "specs")
        blocks: Dict[int, Tuple[Tensor, Any]] = {}   # id(whole) -> block
        modules: Dict[int, list] = {}                # id(module) -> params
        split = set()     # (shape, dtype) of the split updatable inputs

        def gather_leaf(t, spec, updatable=True):
            w = _whole(t, spec, mesh)
            blocks[id(w)] = (t, spec)
            if updatable and t.shape != w.shape:
                split.add((w.shape, w.dtype))
            return w

        def gather_input(t, spec):
            return gather_leaf(t, spec, updatable=False)

        def gather_module(module, specs):
            entries = modules[id(module)] = []
            for name, p in module.named_parameters():
                entries.append((name, p, p.data, specs[name]))
                p.data = _whole(p.data, specs[name], mesh)
                if p.data.shape != entries[-1][2].shape:
                    split.add((p.data.shape, p.data.dtype))
            return module

        def new_output(o):
            if (o.shape, o.dtype) in split:
                raise ValueError(
                    f"the step returned a new {tuple(o.shape)} "
                    f"{o.dtype} tensor shaped as a split input: an input "
                    "updated out of place would come back whole; update "
                    "it in place")
            return o

        def cut_leaf(o, _):
            b, spec = blocks.get(id(o), (None, None))
            if b is None:
                return new_output(o)
            nb = _block(o, spec, mesh)
            if b.shape != nb.shape:
                raise ValueError(f"an updated input's block is "
                                 f"{tuple(nb.shape)}, was {tuple(b.shape)}")
            if nb is not b:
                b.copy_(nb)
            return b

        def cut_module(module, _):
            entries = modules.pop(id(module), None)
            if entries is None:
                for p in module.parameters():
                    new_output(p)
                return module
            for name, p, b, spec in entries:
                w, p.data = p.data, b
                if w is not b:
                    b.copy_(_block(w, spec, mesh))
            return module

        whole = [_walk(gather_input if isinstance(a, Mapping)
                       else gather_leaf, a, s, gather_module)
                 for a, s in zip(args, in_specs)]
        try:
            return _walk(cut_leaf, step(*whole), None, cut_module)
        finally:        # input modules the step did not return: unchanged
            for entries in modules.values():
                for _, p, b, _ in entries:
                    p.data = b

    return run
