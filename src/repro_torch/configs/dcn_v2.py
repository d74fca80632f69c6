"""dcn-v2 [recsys] n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3
mlp=1024-1024-512 interaction=cross [arXiv:2008.13535].

Criteo-style vocabularies: 20 features at 2^20 rows, 6 at 2^23 (hashed):
1.14 G table floats, 4.56 GB in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import P
from repro_torch.models.recsys import (DCNv2, DCNv2Config, dcnv2_forward,
                                       dcnv2_interact, dcnv2_loss,
                                       init_dcnv2, take_fill)
from repro_torch.train.optimizer import adamw_specs

from .recsys_common import (RECSYS_SHAPES, REDUCED_RECSYS_SHAPES,
                            RecsysArchBase, TensorSpec, all_axes, dp_of,
                            recsys_param_spec_tree)

FULL = DCNv2Config(vocab_sizes=tuple([1 << 20] * 20 + [1 << 23] * 6))
REDUCED = DCNv2Config(n_dense=4, n_sparse=5,
                      vocab_sizes=(64, 64, 128, 128, 256), embed_dim=8,
                      n_cross=2, mlp_dims=(32, 16))


class DCNv2Arch(RecsysArchBase):
    name = "dcn-v2"

    def config(self, reduced: bool = False, shape: Optional[str] = None):
        return REDUCED if reduced else FULL

    def module(self, cfg) -> DCNv2:
        return DCNv2(cfg)

    def init(self, cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> DCNv2:
        return init_dcnv2(cfg, generator, device)

    def loss_fn(self, cfg, shape: str):
        """``train`` cells: ``loss(model, batch)`` (``dcnv2_loss``)."""
        if RECSYS_SHAPES[shape]["kind"] != "train":
            raise ValueError(f"{shape} is not a train cell")
        return lambda model, batch: dcnv2_loss(cfg, model, batch)

    def step_fn(self, cfg, shape: str, reduced: bool = False,
                optimized: bool = False):
        """``train``: (model, opt_state, batch) -> (model, opt_state, loss),
        in place.  ``serve``: (model, {dense, sparse}) -> (B,) logits.
        ``retrieval``: (model, {dense, sparse} (B = 1), cand_sparse (n,))
        -> (n,) logits of the user's features with the candidate's id in
        column 0: ``retrieve`` broadcasts the user's ids (its lookups clamp
        as ``default_lookup``); ``optimized`` gives ``retrieve_opt``, which
        looks the 25 user-side features up once (``jnp.take``'s fill mode:
        an id >= V gives NaN)."""
        kind = RECSYS_SHAPES[shape]["kind"]
        if kind == "train":
            return self.make_train(self.loss_fn(cfg, shape))
        if kind == "serve":
            return lambda model, batch: dcnv2_forward(cfg, model, batch)

        def retrieve(model: DCNv2, batch, cand_sparse):
            n = cand_sparse.shape[0]
            dense = batch["dense"].expand(n, -1)
            sparse = batch["sparse"].expand(n, -1).clone()
            sparse[:, 0] = cand_sparse
            return dcnv2_forward(cfg, model, {"dense": dense,
                                              "sparse": sparse})

        def retrieve_opt(model: DCNv2, batch, cand_sparse):
            n = cand_sparse.shape[0]
            user = torch.cat([take_fill(model.tables[i],
                                        batch["sparse"][:, i].clamp_min(0))
                              for i in range(1, cfg.n_sparse)], dim=-1)
            e0 = take_fill(model.tables[0], cand_sparse.clamp_min(0))
            x0 = torch.cat([batch["dense"].expand(n, -1), e0,
                            user.expand(n, -1)], dim=-1)
            return dcnv2_interact(model, x0)

        return retrieve_opt if optimized else retrieve

    def _batch_struct(self, cfg, b: int) -> Dict[str, TensorSpec]:
        return {"dense": TensorSpec((b, cfg.n_dense), torch.float32),
                "sparse": TensorSpec((b, cfg.n_sparse), torch.int32),
                "label": TensorSpec((b,), torch.float32)}

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        spec = (REDUCED_RECSYS_SHAPES if reduced else RECSYS_SHAPES)[shape]
        params = self.abstract_params(cfg)
        if spec["kind"] == "train":
            return (params, adamw_specs(params),
                    self._batch_struct(cfg, spec["batch"]))
        if spec["kind"] == "serve":
            batch = self._batch_struct(cfg, spec["batch"])
            batch.pop("label")
            return (params, batch)
        batch = self._batch_struct(cfg, 1)
        batch.pop("label")
        return (params, batch,
                TensorSpec((spec["n_candidates"],), torch.int32))

    def in_shardings(self, cfg, shape: str, mesh):
        """The reference's specs of the cell's step arguments (the
        parameters keyed by name; the same layouts in both packages)."""
        spec = RECSYS_SHAPES[shape]
        dp = dp_of(mesh)
        pspec = recsys_param_spec_tree(self.abstract_params(cfg), mesh)
        bs = {"dense": P(dp, None), "sparse": P(dp, None),
              "label": P(dp)}
        if spec["kind"] == "train":
            return (pspec, self.opt_specs(pspec), bs)
        if spec["kind"] == "serve":
            bs.pop("label")
            return (pspec, bs)
        rep = {"dense": P(None, None), "sparse": P(None, None)}
        return (pspec, rep, P(all_axes(mesh)))


ARCH = DCNv2Arch()
