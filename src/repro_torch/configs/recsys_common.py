"""Shared machinery for the recsys architectures.

Shapes (as in the reference):
  train_batch    batch=65,536    (train_step)
  serve_p99      batch=512       (online scoring)
  serve_bulk     batch=262,144   (offline scoring)
  retrieval_cand batch=1, n_candidates=1,048,576 (candidate scoring)

``make_train``, ``opt_specs`` and the mesh helpers (``dp_of``,
``all_axes``, ``recsys_param_spec_tree``) wait for training and
``distributed/`` (ROADMAP queue 1 items 8-9).
"""
from __future__ import annotations

from typing import Dict

import torch

from .lm_common import CellDef, TensorSpec, param_specs

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


class RecsysArchBase:
    family = "recsys"

    def cells(self):
        return [CellDef(s, spec["kind"])
                for s, spec in RECSYS_SHAPES.items()]

    def module(self, cfg) -> torch.nn.Module:
        """The arch's model, on the ``meta`` device (nothing allocated)."""
        raise NotImplementedError

    def abstract_params(self, cfg) -> Dict[str, TensorSpec]:
        """Parameter name -> :class:`TensorSpec`, from :meth:`module`."""
        return param_specs(self.module(cfg))
