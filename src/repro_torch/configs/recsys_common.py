"""Shared machinery for the recsys architectures.

Shapes (as in the reference):
  train_batch    batch=65,536    (train_step)
  serve_p99      batch=512       (online scoring)
  serve_bulk     batch=262,144   (offline scoring)
  retrieval_cand batch=1, n_candidates=1,048,576 (candidate scoring)

Embedding tables row-shard on 'model' (vocabs are multiples of 16);
``recsys_param_spec_tree`` decides each spec on the reference's name and
shape.  The explicit sharded lookup is
``distributed.collectives.make_sharded_lookup``.  ``make_train`` builds an
arch's train step from its loss (AdamW with ``lr=1e-3``); ``opt_specs``
lays the optimizer state out as the parameters are.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.distributed.sharding import (P, Layout, same_layout,
                                              tree_param_specs)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig, AdamWState

from .specs import CellDef, TensorSpec, param_specs

RECSYS_SHAPES: Dict[str, Dict] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    # 1,000,000 candidates padded to 2^20 in the reference, so the candidate
    # axis divides its device meshes (padding rows are masked)
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_048_576),
}

REDUCED_RECSYS_SHAPES: Dict[str, Dict] = {
    "train_batch": dict(kind="train", batch=32),
    "serve_p99": dict(kind="serve", batch=8),
    "serve_bulk": dict(kind="serve", batch=64),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=256),
}


def dp_of(mesh):
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return dp_axes if len(dp_axes) > 1 else dp_axes[0]


def all_axes(mesh):
    return tuple(mesh.axis_names)


def recsys_param_spec_tree(params_shape, mesh,
                           layout: Layout = same_layout):
    """Tables -> row-sharded on model; 2-D dense weights -> out-dim on model
    when divisible; rest replicated.  Decided on the reference's names and
    shapes (``layout``: the port's against the reference's), so a port
    name holding ``emb`` or ``tables`` (``user_emb``, ``tables.3``) is a
    table, and an ``nn.Linear``'s out-dim is its first."""
    model = dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)

    def rule(name, shape, mesh):
        if ("emb" in name or "tables" in name) and len(shape) == 2:
            return P("model" if shape[0] % model == 0 else None, None)
        if len(shape) == 2 and shape[1] % model == 0 and shape[1] >= 512:
            return P(None, "model")
        return P(*([None] * len(shape)))

    return tree_param_specs(params_shape, mesh, rule, layout)


class RecsysArchBase:
    family = "recsys"
    opt = AdamWConfig(lr=1e-3)

    def cells(self):
        return [CellDef(s, spec["kind"])
                for s, spec in RECSYS_SHAPES.items()]

    def module(self, cfg) -> torch.nn.Module:
        """The arch's model, on the ``meta`` device (nothing allocated)."""
        raise NotImplementedError

    def abstract_params(self, cfg) -> Dict[str, TensorSpec]:
        """Parameter name -> :class:`TensorSpec`, from :meth:`module`."""
        return param_specs(self.module(cfg))

    def make_train(self, loss_fn: Callable):
        """``train(model, opt_state, batch) -> (model, opt_state, loss)``:
        the loss and its gradients, then one AdamW step with ``self.opt``,
        in place."""
        return make_train_step(loss_fn, self.opt)

    def opt_specs(self, pspec):
        """The optimizer state's specs from the parameters' ``pspec`` (keyed
        by parameter name): each moment as its parameter, the step count
        replicated."""
        return AdamWState(step=P(), mu=pspec, nu=pspec)
