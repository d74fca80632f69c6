"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq [arXiv:1808.09781].

``train_batch`` samples ``N_NEG`` negatives per position; their logits go
through ``SampledLogits`` in blocks of batch rows, so the (B, S, 64, E)
negative embeddings (41.9 GB at B = 65,536) are never whole.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import P
from repro_torch.models.recsys import (SASRec, SASRecConfig, index_rows,
                                       init_sasrec, sasrec_forward,
                                       sasrec_loss)
from repro_torch.train.optimizer import adamw_specs

from .recsys_common import (RECSYS_SHAPES, REDUCED_RECSYS_SHAPES,
                            RecsysArchBase, TensorSpec, all_axes, dp_of,
                            recsys_param_spec_tree)

FULL = SASRecConfig(n_items=1_048_576)
REDUCED = SASRecConfig(n_items=512, embed_dim=16, n_blocks=1, seq_len=10)

N_NEG = 64


class SASRecArch(RecsysArchBase):
    name = "sasrec"

    def config(self, reduced: bool = False, shape: Optional[str] = None):
        return REDUCED if reduced else FULL

    def module(self, cfg) -> SASRec:
        return SASRec(cfg)

    def init(self, cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> SASRec:
        return init_sasrec(cfg, generator, device)

    def loss_fn(self, cfg, shape: str):
        """``train`` cells: ``loss(model, batch)`` (``sasrec_loss``)."""
        if RECSYS_SHAPES[shape]["kind"] != "train":
            raise ValueError(f"{shape} is not a train cell")
        return lambda model, batch: sasrec_loss(cfg, model, batch)

    def step_fn(self, cfg, shape: str, reduced: bool = False):
        """``train``: (model, opt_state, batch) -> (model, opt_state, loss),
        in place.  ``serve``: (model, {seq, target}) -> (B,) scores of the
        last position's state against ``item_emb[clip(target, 0)]``.
        ``retrieval``: (model, {seq} (B = 1), cand_ids (n,)) -> (n,)
        scores, the candidates read by ``item_emb[clip(ids, 0)]``."""
        kind = RECSYS_SHAPES[shape]["kind"]
        if kind == "train":
            return self.make_train(self.loss_fn(cfg, shape))
        if kind == "serve":
            def serve(model: SASRec, batch):
                h = sasrec_forward(cfg, model, batch["seq"])
                tgt = index_rows(model.item_emb, batch["target"].clamp_min(0))
                return (h[:, -1] * tgt).sum(dim=-1)
            return serve

        def retrieve(model: SASRec, batch, cand_ids):
            h = sasrec_forward(cfg, model, batch["seq"])[:, -1]    # (1, E)
            ce = index_rows(model.item_emb, cand_ids.clamp_min(0))  # (N, E)
            return (h @ ce.T)[0]
        return retrieve

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        spec = (REDUCED_RECSYS_SHAPES if reduced else RECSYS_SHAPES)[shape]
        params = self.abstract_params(cfg)
        b, s = spec["batch"], cfg.seq_len
        if spec["kind"] == "train":
            batch: Dict[str, TensorSpec] = {
                "seq": TensorSpec((b, s), torch.int32),
                "pos": TensorSpec((b, s), torch.int32),
                "neg": TensorSpec((b, s, N_NEG), torch.int32)}
            return (params, adamw_specs(params), batch)
        if spec["kind"] == "serve":
            return (params, {"seq": TensorSpec((b, s), torch.int32),
                             "target": TensorSpec((b,), torch.int32)})
        return (params, {"seq": TensorSpec((1, s), torch.int32)},
                TensorSpec((spec["n_candidates"],), torch.int32))

    def in_shardings(self, cfg, shape: str, mesh):
        """The reference's specs of the cell's step arguments (the
        parameters keyed by name; the same layouts in both packages)."""
        spec = RECSYS_SHAPES[shape]
        dp = dp_of(mesh)
        pspec = recsys_param_spec_tree(self.abstract_params(cfg), mesh)
        if spec["kind"] == "train":
            bs = {"seq": P(dp, None), "pos": P(dp, None),
                  "neg": P(dp, None, None)}
            return (pspec, self.opt_specs(pspec), bs)
        if spec["kind"] == "serve":
            return (pspec, {"seq": P(dp, None), "target": P(dp)})
        return (pspec, {"seq": P(None, None)}, P(all_axes(mesh)))


ARCH = SASRecArch()
