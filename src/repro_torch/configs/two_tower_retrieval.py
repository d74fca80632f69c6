"""two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot, sampled-softmax retrieval [RecSys'19 (YouTube)].

``retrieval_cand`` scores one query embedding against a 2^20-item corpus
under a structured predicate (a (B, n) mask): ACORN's hybrid-search
problem.  Ported here on one device: the ``serve`` step and the
``retrieval`` step ``retrieve_local`` (user tower + ``filtered_topk``).
The reference's ``filtered_retrieval_step`` over a device mesh waits for
``distributed/`` (ROADMAP queue 1 item 3), and the ``train`` step for the
losses and the optimizer (queue 1 item 5).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels.filtered_topk import filtered_topk
from repro_torch.models.recsys import (TwoTower, TwoTowerConfig,
                                       init_two_tower)

from .recsys_common import (RECSYS_SHAPES, REDUCED_RECSYS_SHAPES,
                            RecsysArchBase, TensorSpec)

FULL = TwoTowerConfig(n_users=4_194_304, n_items=2_097_152)
REDUCED = TwoTowerConfig(n_users=1024, n_items=512, n_user_feats=2,
                         embed_dim=16, tower_dims=(32, 16))

TOPK = 100


class TwoTowerArch(RecsysArchBase):
    name = "two-tower-retrieval"

    def config(self, reduced: bool = False):
        return REDUCED if reduced else FULL

    def module(self, cfg) -> TwoTower:
        return TwoTower(cfg)

    def init(self, cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> TwoTower:
        return init_two_tower(cfg, generator, device)

    def _batch_struct(self, cfg, b: int) -> Dict[str, TensorSpec]:
        return {
            "user_id": TensorSpec((b,), torch.int32),
            "user_feats": TensorSpec((b, cfg.n_user_feats), torch.int32),
            "item_id": TensorSpec((b,), torch.int32),
            "logq": TensorSpec((b,), torch.float32),
        }

    def step_fn(self, cfg, shape: str, mesh=None):
        """``serve``: (model, batch) -> (B,) user-item scores.
        ``retrieval``: (model, batch, cand_embs (n, E'), mask (B, n)) ->
        (ids (B, k), scores (B, k)), k = min(TOPK, n), +u.v scores."""
        kind = RECSYS_SHAPES[shape]["kind"]
        if kind == "train":
            raise NotImplementedError(
                "the two-tower train step is not ported yet (two_tower_loss "
                "and AdamW: ROADMAP.md queue 1 item 5)")
        if mesh is not None:
            raise NotImplementedError(
                "two-tower steps over a device mesh are not ported yet "
                "(filtered_retrieval_step: ROADMAP.md queue 1 item 3)")
        if kind == "serve":
            # online scoring: user embedding . embedding of the request item
            def serve(model: TwoTower, batch):
                u = model.user_embed(batch)
                v = model.item_embed(batch["item_id"])
                return (u * v).sum(dim=-1)
            return serve

        def retrieve_local(model: TwoTower, batch, cand_embs, mask):
            u = model.user_embed(batch)
            return filtered_topk(u, cand_embs, mask,
                                 min(TOPK, cand_embs.shape[0]), metric="ip")
        return retrieve_local

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        spec = (REDUCED_RECSYS_SHAPES if reduced else RECSYS_SHAPES)[shape]
        if spec["kind"] == "train":
            raise NotImplementedError(
                "train inputs need the optimizer state (AdamW: ROADMAP.md "
                "queue 1 item 5)")
        params = self.abstract_params(cfg)
        b = spec["batch"]
        batch = self._batch_struct(cfg, b)
        if spec["kind"] == "serve":
            return (params, batch)
        n = spec["n_candidates"]
        e = cfg.tower_dims[-1]
        return (params, batch, TensorSpec((n, e), torch.float32),
                TensorSpec((b, n), torch.bool))


ARCH = TwoTowerArch()
