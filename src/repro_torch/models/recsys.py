"""RecSys architectures; so far the two-tower retrieval model.

The reference (``repro/models/recsys.py``) keeps parameters as a pytree
and applies pure functions; here the model is an ``nn.Module`` whose
methods keep the reference's names (``user_embed``, ``item_embed``,
``score_candidates``).  Tower weights are ``nn.Linear`` (out, in), the
transpose of the reference's (d_in, d_out); ``repro_torch.convert``
carries a reference parameter tree across.  :func:`two_tower_loss` is the
train step's loss: an in-batch sampled softmax whose (B, B) logits are
never held whole (:class:`InBatchSoftmax`).

Still to port (ROADMAP queue 1 item 5c): DIEN, SASRec and DCN-v2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .common import cross_entropy, dense_init, embed_init, set_params

Tensor = torch.Tensor

# rows of the (B, B) logits one block of InBatchSoftmax holds: 4,096 rows of
# a 65,536 batch are 1.07 GB of fp32
LOSS_BLOCK = 4096


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
    Parameters do not require grad: serving needs none, and the train
    step (``repro_torch.train.loop.value_and_grad``) turns it on for its
    own call only."""
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


# ---------------------------------------------------------------------------
# training: in-batch sampled softmax with logQ correction
# ---------------------------------------------------------------------------


def in_batch_softmax_ref(u: Tensor, v: Tensor, logq: Tensor,
                         temperature: float) -> Tensor:
    """The plain version: the whole (B, B) logits ``u v^T / T - logq`` and
    a cross-entropy against the diagonal, as the reference writes it."""
    logits = (u @ v.T) / temperature - logq[None, :]
    labels = torch.arange(u.shape[0], device=u.device)
    return cross_entropy(logits, labels)


class InBatchSoftmax(torch.autograd.Function):
    """:func:`in_batch_softmax_ref` in row blocks of ``block``, in the
    inputs' dtype.

    The forward keeps only each row's logsumexp; the backward recomputes
    each block's logits and softmax, so memory is O(block x B) where the
    plain version holds the (B, B) logits, the saved log-softmax and two
    gradients of that size (51.5 GB at B = 65,536)."""

    @staticmethod
    def forward(ctx, u, v, logq, temperature: float, block: int):
        b = u.shape[0]
        lse = u.new_empty(b)
        diag = u.new_empty(b)
        for r in range(0, b, block):
            s = (u[r:r + block] @ v.T).div_(temperature).sub_(logq[None, :])
            lse[r:r + block] = torch.logsumexp(s, dim=-1)
            diag[r:r + block] = s.diagonal(offset=r)
        ctx.save_for_backward(u, v, logq, lse)
        ctx.temperature, ctx.block = temperature, block
        return (lse - diag).mean()

    @staticmethod
    def backward(ctx, g):
        u, v, logq, lse = ctx.saved_tensors
        t, block = ctx.temperature, ctx.block
        b = u.shape[0]
        du = torch.empty_like(u)
        dv = torch.zeros_like(v)
        dlogq = torch.zeros_like(logq) if ctx.needs_input_grad[2] else None
        for r in range(0, b, block):
            rows = slice(r, r + block)
            s = (u[rows] @ v.T).div_(t).sub_(logq[None, :])
            # d loss / d logits = (softmax - onehot) * g / B
            p = s.sub_(lse[rows, None]).exp_()
            p.diagonal(offset=r).sub_(1.0)
            p.mul_(g / b)
            if dlogq is not None:
                dlogq.sub_(p.sum(dim=0))
            p.div_(t)
            du[rows] = p @ v
            dv.addmm_(p.T, u[rows])
        return du, dv, dlogq, None, None


def in_batch_softmax(u: Tensor, v: Tensor, logq: Tensor,
                     temperature: float, block: int = LOSS_BLOCK) -> Tensor:
    """In-batch sampled softmax with logQ correction: user i's positive is
    item i, every other item of the batch a negative, each logit
    ``u_i . v_j / T - logq_j``; the mean negative log-likelihood in fp32
    (float64 inputs stay float64), computed in blocks of ``block`` rows
    (:class:`InBatchSoftmax`)."""
    dt = torch.promote_types(u.dtype, torch.float32)
    return InBatchSoftmax.apply(u.to(dt), v.to(dt), logq.to(dt),
                                temperature, block)


def two_tower_loss(cfg: TwoTowerConfig, model: TwoTower,
                   batch: Dict[str, Tensor], temperature: float = 0.05,
                   block: int = LOSS_BLOCK) -> Tensor:
    """The reference's ``two_tower_loss``: both towers on the batch, then
    the in-batch sampled softmax with logQ correction (``batch['logq']``,
    the log of each item's sampling probability)."""
    u = model.user_embed(batch)                                  # (B, E')
    v = model.item_embed(batch["item_id"])                       # (B, E')
    return in_batch_softmax(u, v, batch["logq"], temperature, block)


def two_tower_score_candidates(cfg: TwoTowerConfig, model: TwoTower,
                               batch: Dict[str, Tensor],
                               cand_item_embs: Tensor) -> Tensor:
    """retrieval_cand as the reference's free function:
    :meth:`TwoTower.score_candidates` (B, N)."""
    return model.score_candidates(batch, cand_item_embs)
