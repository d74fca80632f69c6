"""RecSys architectures; so far the two-tower retrieval model.

The reference (``repro/models/recsys.py``) keeps parameters as a pytree
and applies pure functions; here the model is an ``nn.Module`` whose
methods keep the reference's names (``user_embed``, ``item_embed``,
``score_candidates``).  Tower weights are ``nn.Linear`` (out, in), the
transpose of the reference's (d_in, d_out); ``repro_torch.convert``
carries a reference parameter tree across.

Still to port (ROADMAP queue 1 item 5): ``two_tower_loss``, DIEN, SASRec
and DCN-v2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .common import dense_init, embed_init, set_params

Tensor = torch.Tensor


def default_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """ids (...,) -> (..., D) rows of ``table``; an id < 0 gives zeros and
    an id >= V reads row V - 1 (ids are clipped first)."""
    safe = ids.clamp(0, table.shape[0] - 1).long()
    out = table[safe]
    return torch.where((ids >= 0)[..., None], out, out.new_zeros(()))


# ===========================================================================
# Two-tower retrieval (YouTube/RecSys'19)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_users: int = 5_000_000
    n_items: int = 2_000_000
    n_user_feats: int = 4           # multi-hot user context features
    embed_dim: int = 256
    tower_dims: Tuple[int, ...] = (1024, 512, 256)
    dtype: torch.dtype = torch.float32


def _tower(dims: Sequence[int], dtype) -> nn.ModuleList:
    """Linear layers dims[0] -> ... -> dims[-1], on the meta device."""
    return nn.ModuleList(
        nn.Linear(dims[i], dims[i + 1], device="meta", dtype=dtype)
        for i in range(len(dims) - 1))


def _apply_tower(tower: nn.ModuleList, x: Tensor) -> Tensor:
    """ReLU between layers, none after the last."""
    for i, lin in enumerate(tower):
        x = lin(x)
        if i < len(tower) - 1:
            x = torch.relu(x)
    return x


def _l2_normalize(z: Tensor) -> Tensor:
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(
        1e-6)


class TwoTower(nn.Module):
    """User and item embedding tables plus one MLP tower each.

    Constructed on the ``meta`` device, so nothing is allocated:
    :func:`init_two_tower` draws the parameters and
    ``repro_torch.convert.two_tower_params_from_arrays`` carries a
    reference tree in, both through :func:`set_two_tower_params`."""

    def __init__(self, cfg: TwoTowerConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.user_emb = nn.Parameter(torch.empty(
            (cfg.n_users, e), dtype=cfg.dtype, device="meta"))
        self.item_emb = nn.Parameter(torch.empty(
            (cfg.n_items, e), dtype=cfg.dtype, device="meta"))
        self.user_tower = _tower((e * (1 + cfg.n_user_feats),)
                                 + tuple(cfg.tower_dims), cfg.dtype)
        self.item_tower = _tower((e,) + tuple(cfg.tower_dims), cfg.dtype)

    def user_embed(self, batch: Dict[str, Tensor]) -> Tensor:
        """batch['user_id'] (B,), batch['user_feats'] (B, F) ->
        (B, E') L2-normalised user embeddings."""
        u = default_lookup(self.user_emb, batch["user_id"])      # (B, E)
        f = default_lookup(self.user_emb, batch["user_feats"])   # (B, F, E)
        z = torch.cat([u, f.reshape(u.shape[0], -1)], dim=-1)
        return _l2_normalize(_apply_tower(self.user_tower, z))

    def item_embed(self, item_ids: Tensor) -> Tensor:
        """item_ids (...,) -> (..., E') L2-normalised item embeddings."""
        i = default_lookup(self.item_emb, item_ids)
        return _l2_normalize(_apply_tower(self.item_tower, i))

    def score_candidates(self, batch: Dict[str, Tensor],
                         cand_item_embs: Tensor) -> Tensor:
        """retrieval_cand: the batch's user embeddings against a
        precomputed candidate matrix (N, E') -> (B, N) scores."""
        return self.user_embed(batch) @ cand_item_embs.T


def set_two_tower_params(model: TwoTower, user_emb: Tensor, item_emb: Tensor,
                         towers: Sequence[Sequence[Tuple[Tensor, Tensor]]]
                         ) -> TwoTower:
    """Give ``model`` (built on the ``meta`` device) the tables and the (weight (out, in), bias) pairs of its
    user and item towers, in that order.  The tensors become the
    parameters as they are, without a copy."""
    layers = [list(t) for t in towers]
    if [len(t) for t in layers] != [len(model.user_tower),
                                    len(model.item_tower)]:
        raise ValueError("tower depths do not match the model's")
    slots = [(model, "user_emb", user_emb), (model, "item_emb", item_emb)]
    for tower, pairs in zip((model.user_tower, model.item_tower), layers):
        for lin, (w, b) in zip(tower, pairs):
            slots += [(lin, "weight", w), (lin, "bias", b)]
    set_params(slots)
    return model


def init_two_tower(cfg: TwoTowerConfig,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = "cuda") -> TwoTower:
    """A :class:`TwoTower` on ``device`` with the reference's initial law:
    tables N(0, 0.02^2), tower weights N(0, 1/d_in), zero biases.  Draws
    from ``generator`` (on ``device``; a fresh one seeded 0 if None) in the
    reference's order: user table, item table, user tower, item tower.
    Parameters do not require grad: the ported steps only serve."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    e = cfg.embed_dim
    user_emb = embed_init(generator, cfg.n_users, e, cfg.dtype)
    item_emb = embed_init(generator, cfg.n_items, e, cfg.dtype)
    model = TwoTower(cfg)
    towers = [[(dense_init(generator, lin.in_features, lin.out_features,
                           cfg.dtype).T.contiguous(),
                torch.zeros(lin.out_features, dtype=cfg.dtype, device=dev))
               for lin in tower]
              for tower in (model.user_tower, model.item_tower)]
    return set_two_tower_params(model, user_emb, item_emb, towers)
