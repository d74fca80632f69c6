"""pna [gnn] 4L d_hidden=75, aggregators=mean-max-min-std,
scalers=id-amp-atten [arXiv:2004.05718].

Shapes (as in the reference):
  full_graph_sm  n=2,708  e=10,556   d_feat=1,433  (Cora; full-batch)
  minibatch_lg   n=232,965 e=114,615,892 batch_nodes=1,024 fanout=15-10
  ogb_products   n=2,449,029 e=61,859,140 d_feat=100 (full-batch-large)
  molecule       n=30 e=64 batch=128 (dense-batched; fused aggregator)

Each cell's train step is its regime's loss, its gradients, then one
AdamW step, as in the reference:

* ``molecule`` (dense): ``loss_dense`` with ``use_kernel=False``, the plain
  aggregator, as the reference trains;
* ``full_graph_sm``, ``ogb_products`` (sparse): ``loss_sparse`` over the
  whole edge list, its layers through ``SegmentAggregate``;
* ``minibatch_lg``: ``forward_minibatch`` over two sampled blocks (hop 2,
  then hop 1), the cross-entropy of the seeds' rows.  With 4 layers and 2
  blocks, layers 3-4 take no part in the loss: their gradients are zero
  and AdamW only decays them, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import P
from repro_torch.models.common import cross_entropy
from repro_torch.models.gnn import (PNA, PNAConfig, forward_minibatch,
                                    init_pna, loss_dense, loss_sparse,
                                    take_rows)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_specs)

from .recsys_common import dp_of
from .specs import CellDef, TensorSpec, param_specs


def _pad(n, m):
    return ((n + m - 1) // m) * m


PNA_SHAPES: Dict[str, Dict] = {
    "full_graph_sm": dict(kind="train", regime="sparse", n_nodes=2708,
                          n_edges=_pad(10556, 512), d_feat=1433, classes=7),
    "minibatch_lg": dict(kind="train", regime="minibatch", seeds=1024,
                         fanouts=(15, 10), d_feat=602, classes=41,
                         block_nodes=_pad(1024 * (1 + 15 + 150), 512),
                         hop_edges=(_pad(1024 * 15 * 10, 512),
                                    _pad(1024 * 15, 512))),
    "ogb_products": dict(kind="train", regime="sparse",
                         n_nodes=_pad(2449029, 512),
                         n_edges=_pad(61859140, 512), d_feat=100,
                         classes=47),
    "molecule": dict(kind="train", regime="dense", batch=128, n_nodes=30,
                     d_feat=16, classes=2),
}

REDUCED_SHAPES: Dict[str, Dict] = {
    "full_graph_sm": dict(kind="train", regime="sparse", n_nodes=200,
                          n_edges=800, d_feat=32, classes=7),
    "minibatch_lg": dict(kind="train", regime="minibatch", seeds=8,
                         fanouts=(3, 2), d_feat=16, classes=5,
                         block_nodes=64, hop_edges=(48, 24)),
    "ogb_products": dict(kind="train", regime="sparse", n_nodes=300,
                         n_edges=1200, d_feat=16, classes=8),
    "molecule": dict(kind="train", regime="dense", batch=4, n_nodes=12,
                     d_feat=8, classes=2),
}

class PNAArch:
    family = "gnn"
    name = "pna"
    opt = AdamWConfig(lr=1e-3)

    def config(self, reduced: bool = False, shape: str = "full_graph_sm"):
        spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)[shape]
        return PNAConfig(n_layers=4 if not reduced else 2,
                         d_in=spec["d_feat"], d_hidden=75 if not reduced
                         else 16, n_classes=spec["classes"])

    def cells(self):
        return [CellDef(s, "train") for s in PNA_SHAPES]

    def module(self, cfg) -> PNA:
        """The model on the ``meta`` device (nothing allocated)."""
        return PNA(cfg)

    def init(self, cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> PNA:
        return init_pna(cfg, generator, device)

    def abstract_params(self, cfg) -> Dict[str, TensorSpec]:
        """Parameter name -> :class:`TensorSpec`, from :meth:`module`."""
        return param_specs(self.module(cfg))

    def loss_fn(self, cfg, shape: str, reduced: bool = False):
        """``loss(model, batch)``, the scalar the train step
        differentiates, for the cell's regime."""
        regime = (REDUCED_SHAPES if reduced else PNA_SHAPES)[shape]["regime"]
        if regime == "dense":
            def loss(model: PNA, batch):
                return loss_dense(cfg, model, batch["feats"], batch["adj"],
                                  batch["labels"], use_kernel=False)
        elif regime == "sparse":
            def loss(model: PNA, batch):
                return loss_sparse(cfg, model, batch["feats"], batch["src"],
                                   batch["dst"], batch["labels"],
                                   batch["label_mask"])
        else:
            def loss(model: PNA, batch):
                logits = forward_minibatch(
                    cfg, model, batch["feats"],
                    [(batch["src2"], batch["dst2"]),
                     (batch["src1"], batch["dst1"])],
                    batch["feats"].shape[0])
                return cross_entropy(take_rows(logits, batch["seed_idx"]),
                                     batch["labels"])
        return loss

    def step_fn(self, cfg, shape: str, reduced: bool = False):
        """(model, opt_state, batch) -> (model, opt_state, loss): the loss
        and its gradients, then one AdamW step, in place."""
        return make_train_step(self.loss_fn(cfg, shape, reduced), self.opt)

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        """(parameter specs, AdamW state specs, batch specs) of a cell."""
        spec = (REDUCED_SHAPES if reduced else PNA_SHAPES)[shape]
        params = self.abstract_params(cfg)
        f32, i32 = torch.float32, torch.int32
        if spec["regime"] == "sparse":
            n, e = spec["n_nodes"], spec["n_edges"]
            batch = {"feats": TensorSpec((n, spec["d_feat"]), f32),
                     "src": TensorSpec((e,), i32),
                     "dst": TensorSpec((e,), i32),
                     "labels": TensorSpec((n,), i32),
                     "label_mask": TensorSpec((n,), f32)}
        elif spec["regime"] == "dense":
            b, nn = spec["batch"], spec["n_nodes"]
            batch = {"feats": TensorSpec((b, nn, spec["d_feat"]), f32),
                     "adj": TensorSpec((b, nn, nn), f32),
                     "labels": TensorSpec((b,), i32)}
        else:
            nb = spec["block_nodes"]
            e2, e1 = spec["hop_edges"]
            batch = {"feats": TensorSpec((nb, spec["d_feat"]), f32),
                     "src1": TensorSpec((e1,), i32),
                     "dst1": TensorSpec((e1,), i32),
                     "src2": TensorSpec((e2,), i32),
                     "dst2": TensorSpec((e2,), i32),
                     "seed_idx": TensorSpec((spec["seeds"],), i32),
                     "labels": TensorSpec((spec["seeds"],), i32)}
        return (params, adamw_specs(params), batch)

    def in_shardings(self, cfg, shape: str, mesh):
        """The reference's specs of the cell's step arguments: parameters
        and moments replicated; the batch by regime (the sparse regime's
        nodes on ``model`` for the padded large graphs, whose node count
        is a multiple of 512; Cora's replicated)."""
        spec = PNA_SHAPES[shape]
        dp = dp_of(mesh)
        pspec = {k: P() for k in self.abstract_params(cfg)}
        ospec = AdamWState(step=P(), mu=pspec, nu=pspec)
        if spec["regime"] == "sparse":
            nspec = "model" if spec["n_nodes"] % 512 == 0 else None
            batch = {"feats": P(nspec, None), "src": P(dp), "dst": P(dp),
                     "labels": P(nspec), "label_mask": P(nspec)}
        elif spec["regime"] == "dense":
            batch = {"feats": P(dp, None, None), "adj": P(dp, None, None),
                     "labels": P(dp)}
        else:
            batch = {"feats": P("model", None),
                     "src1": P(dp), "dst1": P(dp),
                     "src2": P(dp), "dst2": P(dp),
                     "seed_idx": P(dp), "labels": P(dp)}
        return (pspec, ospec, batch)


ARCH = PNAArch()
