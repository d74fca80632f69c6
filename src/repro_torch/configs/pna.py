"""pna [gnn] 4L d_hidden=75, aggregators=mean-max-min-std,
scalers=id-amp-atten [arXiv:2004.05718].

Shapes (as in the reference):
  full_graph_sm  n=2,708  e=10,556   d_feat=1,433  (Cora; full-batch)
  minibatch_lg   n=232,965 e=114,615,892 batch_nodes=1,024 fanout=15-10
  ogb_products   n=2,449,029 e=61,859,140 d_feat=100 (full-batch-large)
  molecule       n=30 e=64 batch=128 (dense-batched; fused aggregator)

Ported here: the model, its parameters and the dense-batched inference
``repro_torch.models.gnn.forward_dense`` (the path that reaches the
``pna_aggregate`` kernel).  Every cell of the reference is a train step,
and those wait for the losses and AdamW (ROADMAP.md queue 1 item 5), so
``step_fn`` and ``abstract_inputs`` raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.gnn import PNA, PNAConfig, init_pna

from .lm_common import CellDef, TensorSpec, param_specs


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

_NOT_PORTED = ("the PNA train steps are not ported yet (the losses and "
               "AdamW: ROADMAP.md queue 1 item 5); inference is "
               "repro_torch.models.gnn.forward_dense")


class PNAArch:
    family = "gnn"
    name = "pna"

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

    def step_fn(self, cfg, shape: str, reduced: bool = False):
        raise NotImplementedError(_NOT_PORTED)

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        raise NotImplementedError(_NOT_PORTED)


ARCH = PNAArch()
