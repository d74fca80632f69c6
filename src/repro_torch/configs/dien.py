"""dien [recsys] embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru [arXiv:1809.03672].

retrieval_cand scores 2^20 candidates for one user: the interest-extractor
GRU runs once; attention and the AUGRU re-run per chunk of candidates
(the AUGRU is target-conditioned, so that cost is intrinsic to DIEN).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import P
from repro_torch.models.recsys import (DIEN, DIENConfig, dien_forward,
                                       dien_loss, dien_score_candidates,
                                       init_dien)
from repro_torch.train.optimizer import adamw_specs

from .recsys_common import (RECSYS_SHAPES, REDUCED_RECSYS_SHAPES,
                            RecsysArchBase, TensorSpec, all_axes, dp_of,
                            recsys_param_spec_tree)

FULL = DIENConfig(n_items=1_048_576, n_cates=16_384)
REDUCED = DIENConfig(n_items=512, n_cates=64, embed_dim=8, seq_len=12,
                     gru_dim=16, mlp_dims=(16, 8))

# candidates per chunk of retrieval_cand (the reference's, REDUCED: 64)
CHUNK = {False: 4096, True: 64}


class DIENArch(RecsysArchBase):
    name = "dien"

    def config(self, reduced: bool = False, shape: Optional[str] = None):
        return REDUCED if reduced else FULL

    def module(self, cfg) -> DIEN:
        return DIEN(cfg)

    def init(self, cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> DIEN:
        return init_dien(cfg, generator, device)

    def loss_fn(self, cfg, shape: str):
        """``train`` cells: ``loss(model, batch)`` (``dien_loss``)."""
        if RECSYS_SHAPES[shape]["kind"] != "train":
            raise ValueError(f"{shape} is not a train cell")
        return lambda model, batch: dien_loss(cfg, model, batch)

    def step_fn(self, cfg, shape: str, reduced: bool = False):
        """``train``: (model, opt_state, batch) -> (model, opt_state, loss),
        in place.  ``serve``: (model, batch) -> (B,) logits.
        ``retrieval``: (model, batch (B = 1), cand_items (n,), cand_cates
        (n,)) -> (n,) logits, in chunks of ``CHUNK[reduced]``."""
        kind = RECSYS_SHAPES[shape]["kind"]
        if kind == "train":
            return self.make_train(self.loss_fn(cfg, shape))
        if kind == "serve":
            return lambda model, batch: dien_forward(cfg, model, batch)

        def retrieve(model: DIEN, batch, cand_items, cand_cates):
            return dien_score_candidates(cfg, model, batch, cand_items,
                                         cand_cates, chunk=CHUNK[reduced])
        return retrieve

    def _batch_struct(self, cfg, b: int) -> Dict[str, TensorSpec]:
        return {
            "hist_items": TensorSpec((b, cfg.seq_len), torch.int32),
            "hist_cates": TensorSpec((b, cfg.seq_len), torch.int32),
            "mask": TensorSpec((b, cfg.seq_len), torch.float32),
            "target_item": TensorSpec((b,), torch.int32),
            "target_cate": TensorSpec((b,), torch.int32),
            "label": TensorSpec((b,), torch.float32),
        }

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        spec = (REDUCED_RECSYS_SHAPES if reduced else RECSYS_SHAPES)[shape]
        params = self.abstract_params(cfg)
        batch = self._batch_struct(cfg, spec["batch"])
        if spec["kind"] == "train":
            return (params, adamw_specs(params), batch)
        if spec["kind"] == "serve":
            return (params, batch)
        n = spec["n_candidates"]
        return (params, batch, TensorSpec((n,), torch.int32),
                TensorSpec((n,), torch.int32))

    def in_shardings(self, cfg, shape: str, mesh):
        """The reference's specs of the cell's step arguments (the
        parameters keyed by name; the same layouts in both packages)."""
        spec = RECSYS_SHAPES[shape]
        dp = dp_of(mesh)
        pspec = recsys_param_spec_tree(self.abstract_params(cfg), mesh)
        bs = {"hist_items": P(dp, None), "hist_cates": P(dp, None),
              "mask": P(dp, None), "target_item": P(dp),
              "target_cate": P(dp), "label": P(dp)}
        if spec["kind"] == "train":
            return (pspec, self.opt_specs(pspec), bs)
        if spec["kind"] == "serve":
            return (pspec, bs)
        rep = {"hist_items": P(None, None), "hist_cates": P(None, None),
               "mask": P(None, None), "target_item": P(None),
               "target_cate": P(None), "label": P(None)}
        return (pspec, rep, P(all_axes(mesh)), P(all_axes(mesh)))


ARCH = DIENArch()
