"""two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot, sampled-softmax retrieval [RecSys'19 (YouTube)].

``retrieval_cand`` scores one query embedding against a 2^20-item corpus
under a structured predicate (a (B, n) mask): ACORN's hybrid-search
problem.  Ported: the ``serve`` step, the one-device ``retrieval`` step
``retrieve_local`` (user tower + ``filtered_topk``) and the mesh-explicit
:func:`filtered_retrieval_step` (candidates split over every mesh axis,
per-shard top-k, k-row all-gather, merge).  The ``train`` step: the
in-batch sampled softmax ``two_tower_loss`` (blocked, so the (B, B) logits
of ``train_batch``'s 65,536 rows are never whole) and one AdamW step, in
place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.collectives import Mesh, all_gather_cat, top_k
from repro_torch.distributed.sharding import P, linear_layout, place
from repro_torch.kernels.filtered_topk import filtered_topk
from repro_torch.models.recsys import (TwoTower, TwoTowerConfig,
                                       init_two_tower, two_tower_loss)
from repro_torch.train.optimizer import adamw_specs

from .recsys_common import (RECSYS_SHAPES, REDUCED_RECSYS_SHAPES,
                            RecsysArchBase, TensorSpec, all_axes, dp_of,
                            recsys_param_spec_tree)

FULL = TwoTowerConfig(n_users=4_194_304, n_items=2_097_152)
REDUCED = TwoTowerConfig(n_users=1024, n_items=512, n_user_feats=2,
                         embed_dim=16, tower_dims=(32, 16))

TOPK = 100


def filtered_retrieval_step(mesh: Mesh, cfg: TwoTowerConfig, k: int = TOPK):
    """``step(model, batch, cand_l (N_l, E'), mask_l (B, N_l), base=0)`` ->
    (ids, scores) (B, k), whole and identical on every rank of ``mesh``.

    Candidates split over every mesh axis: each rank passes its row block
    of the candidate embeddings (N / mesh size rows; a rank outside the
    mesh passes any block of that size), the matching mask columns and the
    block's first row ``base``; it scores masked dot products (``torch.matmul``,
    fp32), keeps a local top ``min(k, N_l)``, and the k-candidates-per-shard
    merge is an all-gather of k rows along each mesh axis + a local
    top-k.  Selections are :func:`repro_torch.distributed.collectives.
    top_k` (lower index first on equal scores, as ``lax.top_k``).  As in
    the reference, a masked candidate keeps its id with a ``-inf`` score
    when fewer than k pass.  The reference's mesh step is plain jnp, not the
    Pallas kernel; so is this one (no ``filtered_topk``)."""
    axes = tuple(mesh.axis_names)

    def step(model: TwoTower, batch, cand_l, mask_l, base: int = 0):
        u = model.user_embed(batch)                        # (B, E')
        b = u.shape[0]
        outs = None
        if mesh.coordinate is not None:
            s = u @ cand_l.T                               # (B, N_local)
            s = torch.where(mask_l, s, torch.full_like(s, float("-inf")))
            kl = min(k, s.shape[1])                        # small meshes
            top_s, top_i = top_k(s, kl)
            ids = (top_i + base).to(torch.int32)
            for ax in axes:
                top_s = all_gather_cat(top_s, mesh, ax, dim=1)
                ids = all_gather_cat(ids, mesh, ax, dim=1)
            s2, pos = top_k(top_s, min(k, top_s.shape[1]))
            outs = (torch.gather(ids, 1, pos), s2)
        kk = min(k, mesh.size * min(k, cand_l.shape[0]))
        return mesh.share(outs, [((b, kk), torch.int32),
                                 ((b, kk), torch.float32)], u.device)

    step.mesh_explicit = True       # each rank passes its own blocks
    return step


class TwoTowerArch(RecsysArchBase):
    name = "two-tower-retrieval"

    def config(self, reduced: bool = False, shape: Optional[str] = None):
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

    def loss_fn(self, cfg, shape: str):
        """``train`` cells: ``loss(model, batch)``, the scalar the train
        step differentiates (``two_tower_loss``)."""
        if RECSYS_SHAPES[shape]["kind"] != "train":
            raise ValueError(f"{shape} is not a train cell")

        def loss(model: TwoTower, batch):
            return two_tower_loss(cfg, model, batch)
        return loss

    def step_fn(self, cfg, shape: str, mesh=None):
        """``train``: (model, opt_state, batch) -> (model, opt_state, loss),
        the model and the AdamW state updated in place.
        ``serve``: (model, batch) -> (B,) user-item scores.
        ``retrieval``: (model, batch, cand_embs (n, E'), mask (B, n)) ->
        (ids (B, k), scores (B, k)), k = min(TOPK, n), +u.v scores; with a
        ``mesh``, :func:`filtered_retrieval_step` (each rank passes its
        candidate block, mask columns and base row)."""
        kind = RECSYS_SHAPES[shape]["kind"]
        if kind == "train":
            return self.make_train(self.loss_fn(cfg, shape))
        if kind == "serve":
            # online scoring: user embedding . embedding of the request item
            def serve(model: TwoTower, batch):
                u = model.user_embed(batch)
                v = model.item_embed(batch["item_id"])
                return (u * v).sum(dim=-1)
            return serve
        if mesh is not None:
            return filtered_retrieval_step(mesh, cfg)

        def retrieve_local(model: TwoTower, batch, cand_embs, mask):
            u = model.user_embed(batch)
            return filtered_topk(u, cand_embs, mask,
                                 min(TOPK, cand_embs.shape[0]), metric="ip")
        return retrieve_local

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        spec = (REDUCED_RECSYS_SHAPES if reduced else RECSYS_SHAPES)[shape]
        params = self.abstract_params(cfg)
        b = spec["batch"]
        batch = self._batch_struct(cfg, b)
        if spec["kind"] == "train":
            return (params, adamw_specs(params), batch)
        if spec["kind"] == "serve":
            return (params, batch)
        n = spec["n_candidates"]
        e = cfg.tower_dims[-1]
        return (params, batch, TensorSpec((n, e), torch.float32),
                TensorSpec((b, n), torch.bool))

    def in_shardings(self, cfg, shape: str, mesh):
        """The reference's specs of the cell's step arguments, the
        parameters' keyed by the port's names (the towers' ``nn.Linear``
        weights carry the reference's (in, out) spec transposed)."""
        spec = RECSYS_SHAPES[shape]
        dp = dp_of(mesh)
        axes = all_axes(mesh)
        pspec = recsys_param_spec_tree(
            self.abstract_params(cfg), mesh,
            linear_layout("user_tower", "item_tower"))
        bs = {"user_id": P(dp), "user_feats": P(dp, None),
              "item_id": P(dp), "logq": P(dp)}
        if spec["kind"] == "train":
            return (pspec, self.opt_specs(pspec), bs)
        if spec["kind"] == "serve":
            return (pspec, bs)
        rep = {k: P(*([None] * (2 if k == "user_feats" else 1)))
               for k in bs}
        return (pspec, rep, P(axes, None), P(None, axes))

    def place_inputs(self, shape: str, mesh: Mesh, model, batch, cand_embs,
                     mask):
        """The mesh step's arguments on this rank (``retrieval`` cells)
        from whole ones: the model and the batch whole, as every serving
        rank holds them; the candidates' row block and the mask's columns,
        cut by :meth:`in_shardings`' specs; then the block's first row.
        (The reference's specs also split the embedding tables, whose
        looked-up rows its compiled step gathers.)"""
        specs = self.in_shardings(self.config(), shape, mesh)[2:]
        cand_l, mask_l = place((cand_embs, mask), specs, mesh)
        return (model, batch, cand_l, mask_l,
                mesh.block_start(cand_embs.shape[0], all_axes(mesh)))


ARCH = TwoTowerArch()
