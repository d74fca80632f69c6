"""RecSys architectures: two-tower retrieval, DIEN, SASRec and DCN-v2.

The reference (``repro/models/recsys.py``) keeps parameters as a pytree
and applies pure functions; here each model is an ``nn.Module`` and the
functions keep the reference's names.  Two-tower's tower weights are
``nn.Linear`` (out, in), the transpose of the reference's (d_in, d_out);
DIEN, SASRec and DCN-v2 keep the reference's layouts and its tree's
paths as parameter names (``gru1.wi``, ``blocks.0.wq``, ``tables.3``).
``repro_torch.convert`` carries a reference parameter tree across.

Three losses are blocked so that their largest tensors are never whole at
``train_batch`` (B = 65,536): two-tower's (B, B) logits
(:class:`InBatchSoftmax`), SASRec's (B, S, 64, E) negative embeddings
(:class:`SampledLogits`) and DIEN's per-step GRU gates (:class:`GRUScan`).
Each has its plain version beside it (``in_batch_softmax_ref``,
``sampled_logits_ref``, ``gru_scan_ref``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .common import (bce_with_logits, cross_entropy, dense_init, embed_init,
                     mlp, set_named_params, set_params, take_rows)

Tensor = torch.Tensor

# rows of the (B, B) logits one block of InBatchSoftmax holds: 4,096 rows of
# a 65,536 batch are 1.07 GB of fp32
LOSS_BLOCK = 4096


def default_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """ids (...,) -> (..., D) rows of ``table``; an id < 0 gives zeros and
    an id >= V reads row V - 1 (ids are clipped first).  The gather is
    ``F.embedding``, whose backward sums a row's repeats in parallel
    pieces: ``table[ids]``'s backward on CUDA walks them one by one, 460 ms
    a call for DIEN's Zipf-skewed histories at B = 65,536, and DIEN's step
    takes 2,378 ms with it against 613 ms (``tests/dien_lookup_probe.py``
    on an NVIDIA H100 80GB HBM3 at 700.00 W)."""
    safe = ids.clamp(0, table.shape[0] - 1).long()
    out = F.embedding(safe, table)
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


# ===========================================================================
# shared by DIEN, SASRec and DCN-v2
# ===========================================================================

# rows of the batch one block of SampledLogits holds: 2,048 rows of SASRec's
# (S, 64, E) = (50, 64, 50) negatives are 1.31 GB of fp32
NEG_BLOCK = 2048


def index_rows(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]`` for ids of any shape as ``jnp`` indexing computes it:
    a negative id wraps once (-1 reads the last row), an id still outside
    [0, V) reads the nearest end row and passes no gradient."""
    rows = take_rows(table, ids.reshape(-1))
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def take_fill(table: Tensor, ids: Tensor) -> Tensor:
    """``jnp.take(table, ids, axis=0)`` in its default ``"fill"`` mode, for
    ids >= 0: an id >= V gives a row of NaN."""
    v = table.shape[0]
    out = table[ids.clamp(0, v - 1).long()]
    return torch.where((ids < v)[..., None], out, float("nan"))


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))


class MLPParams(nn.Module):
    """The reference's ``{"w": [(d_in, d_out), ...], "b": [(d_out,), ...]}``
    (parameters ``w.i`` and ``b.i``, the reference's layouts)."""

    def __init__(self, dims: Sequence[int], dtype):
        super().__init__()
        self.w = nn.ParameterList(_param(dims[i], dims[i + 1], dtype=dtype)
                                  for i in range(len(dims) - 1))
        self.b = nn.ParameterList(_param(dims[i + 1], dtype=dtype)
                                  for i in range(len(dims) - 1))

    def forward(self, x: Tensor, final_act: bool = False) -> Tensor:
        return mlp(x, list(self.w), list(self.b), final_act=final_act)


def init_module(model: nn.Module, generator: torch.Generator,
                dev: torch.device, scales: Optional[Dict[str, float]] = None
                ) -> nn.Module:
    """Fill ``model`` (built on ``meta``) with the reference's initial law,
    drawn from ``generator`` (on ``dev``) in parameter order: tables
    (``*_emb``, ``tables.*``) N(0, 0.02^2), other matrices N(0, 1/d_in)
    (or the std ``scales[name]``), vectors (biases, norm weights) zeros.
    Parameters do not require grad (the train step turns it on for its own
    call)."""
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    scales = scales or {}
    named = {}
    for name, p in model.named_parameters():
        if p.dim() == 1:
            named[name] = torch.zeros(p.shape, dtype=p.dtype, device=dev)
        elif name.endswith("emb") or name.startswith("tables."):
            named[name] = embed_init(generator, *p.shape, p.dtype)
        else:
            named[name] = dense_init(generator, *p.shape, p.dtype,
                                     scale=scales.get(name))
    return set_named_params(model, named)


def _generator(generator: Optional[torch.Generator],
               dev: torch.device) -> torch.Generator:
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return generator


# ===========================================================================
# DIEN (arXiv:1809.03672): GRU interest extractor + AUGRU interest evolution
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    n_items: int = 1_000_000
    n_cates: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: Tuple[int, ...] = (200, 80)
    dtype: torch.dtype = torch.float32


class GRUParams(nn.Module):
    """``wi`` (d_in, 3G), ``wh`` (G, 3G) and the input-side bias ``b``
    (3G,), gates in the order r, z, n."""

    def __init__(self, d_in: int, d_h: int, dtype):
        super().__init__()
        self.wi = _param(d_in, 3 * d_h, dtype=dtype)
        self.wh = _param(d_h, 3 * d_h, dtype=dtype)
        self.b = _param(3 * d_h, dtype=dtype)


def _cell(gi: Tensor, h: Tensor, wh: Tensor, a: Optional[Tensor]):
    """One GRU step from the input-side gates ``gi = x @ wi + b`` ((B, 3G),
    or (3G,) shared by every row): ``(h', (gh, r, z_gate, z, n))``."""
    g = wh.shape[0]
    gh = h @ wh
    rz = torch.sigmoid(gi[..., :2 * g] + gh[:, :2 * g])
    r, zg = rz[:, :g], rz[:, g:]
    n = torch.tanh(torch.addcmul(gi[..., 2 * g:], r, gh[:, 2 * g:]))
    z = zg if a is None else zg * a[:, None]
    return torch.lerp(h, n, z), (gh, r, zg, z, n)


def gru_cell(p: GRUParams, h: Tensor, x: Tensor,
             a: Optional[Tensor] = None) -> Tensor:
    """The reference's ``_gru_cell``: a GRU step (bias on the input side
    only, ``h_n`` entering as ``r * h_n``); with ``a`` (B,) the update gate
    is scaled by the attention score, DIEN's AUGRU."""
    return _cell(torch.addmm(p.b, x, p.wi), h, p.wh, a)[0]


def gru_scan_ref(p: GRUParams, xs: Tensor, mask: Tensor,
                 a: Optional[Tensor] = None) -> Tensor:
    """The plain version of :func:`gru_scan`: the reference's masked scan
    step by step under autograd, ``h = where(m > 0, cell(h, x), h)`` from
    zeros; (B, S, G) the state after each step."""
    h = xs.new_zeros((xs.shape[0], p.wh.shape[0]))
    out = []
    for t in range(xs.shape[1]):
        h2 = gru_cell(p, h, xs[:, t], None if a is None else a[:, t])
        h = torch.where(mask[:, t, None] > 0, h2, h)
        out.append(h)
    return torch.stack(out, dim=1)


class GRUScan(torch.autograd.Function):
    """:func:`gru_scan_ref` with a hand-written backward.

    The forward keeps only the states (B, S, G), written into one tensor;
    the backward walks the steps in reverse, recomputes each step's gates
    from (x, h, a) and forms their gradients.  Under autograd the plain
    loop keeps ~9 (B, G) tensors a step: at DIEN's train_batch (B = 65,536,
    two 100-step scans) ~51 GB by that count, here the two scans' states,
    5.7 GB."""

    @staticmethod
    def forward(ctx, xs, mask, a, wi, wh, b, last_only: bool,
                keep_states: bool):
        bsz, s, _ = xs.shape
        keep = mask > 0
        h = xs.new_zeros((bsz, wh.shape[0]))
        hs = (xs.new_empty((bsz, s, wh.shape[0]))
              if keep_states or not last_only else None)
        for t in range(s):
            h2 = _cell(torch.addmm(b, xs[:, t], wi), h, wh,
                       None if a is None else a[:, t])[0]
            if hs is None:
                h = torch.where(keep[:, t, None], h2, h)
            else:
                torch.where(keep[:, t, None], h2, h, out=hs[:, t])
                h = hs[:, t]
        if keep_states:
            ctx.save_for_backward(xs, keep, a, wi, wh, b, hs)
        ctx.last_only = last_only
        return h.clone() if last_only else hs

    @staticmethod
    def backward(ctx, gout):
        xs, keep, a, wi, wh, b, hs = ctx.saved_tensors
        bsz, s, d = xs.shape
        g = wh.shape[0]
        need_x, need_a = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        dxs = xs.new_empty((s, bsz, d)) if need_x else None   # time-major
        da = torch.empty_like(a) if need_a else None
        dwi, dwh, db = (torch.zeros_like(w) for w in (wi, wh, b))
        dgi = xs.new_empty((bsz, 3 * g))
        dgh = xs.new_empty((bsz, 3 * g))
        h0 = xs.new_zeros((bsz, g))
        dh = gout.clone() if ctx.last_only else gout[:, s - 1].clone()
        for t in reversed(range(s)):
            x_t = xs[:, t]
            h = hs[:, t - 1] if t > 0 else h0
            a_t = None if a is None else a[:, t]
            _, (gh, r, zg, z, n) = _cell(torch.addmm(b, x_t, wi), h, wh, a_t)
            # h_t = where(m, h + z (n - h), h)
            dh2 = torch.where(keep[:, t, None], dh, 0.0)
            dz = dh2 * (n - h)
            dn = dh2 * z
            dh_prev = (dh - dh2).addcmul_(dh2, 1.0 - z)
            if a is not None:
                if need_a:
                    da[:, t] = (dz * zg).sum(dim=-1)
                dz = dz * a_t[:, None]
            dpn = dn * (1.0 - n * n)
            torch.mul(dpn, r, out=dgh[:, 2 * g:])
            dgi[:, 2 * g:] = dpn
            dgi[:, g:2 * g] = dz * zg * (1.0 - zg)
            dgi[:, :g] = dpn * gh[:, 2 * g:] * r * (1.0 - r)
            dgh[:, :2 * g] = dgi[:, :2 * g]
            dh_prev.addmm_(dgh, wh.T)
            if need_x:
                torch.mm(dgi, wi.T, out=dxs[t])
            dwi.addmm_(x_t.T, dgi)
            dwh.addmm_(h.T, dgh)
            db.add_(dgi.sum(dim=0))
            dh = dh_prev if ctx.last_only or t == 0 else \
                dh_prev.add_(gout[:, t - 1])
        return (None if dxs is None else dxs.transpose(0, 1), None, da,
                dwi, dwh, db, None, None)


def gru_scan(p: GRUParams, xs: Tensor, mask: Tensor,
             a: Optional[Tensor] = None, last_only: bool = False) -> Tensor:
    """The reference's masked scan of the GRU (AUGRU with ``a`` (B, S)) over
    xs (B, S, D) from zeros: (B, S, G) the state after each step (a masked
    step carries the state), or with ``last_only`` the last (B, G).
    Differentiable through :class:`GRUScan`; without grad it keeps no
    states it does not return."""
    tensors = [xs, p.wi, p.wh, p.b] + ([] if a is None else [a])
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return GRUScan.apply(xs, mask, a, p.wi, p.wh, p.b, last_only, keep)


class DIEN(nn.Module):
    """Item and category tables, the interest-extractor GRU, the AUGRU, the
    attention matrix and the head MLP, in the reference's layouts (names
    ``gru1.wi``, ``mlp.w.0``, ...).  Built on ``meta``: :func:`init_dien`
    draws the parameters, ``repro_torch.convert.dien_params_from_arrays``
    carries a reference tree in."""

    def __init__(self, cfg: DIENConfig):
        super().__init__()
        self.cfg = cfg
        e, g, dt = cfg.embed_dim, cfg.gru_dim, cfg.dtype
        self.item_emb = _param(cfg.n_items, e, dtype=dt)
        self.cate_emb = _param(cfg.n_cates, e, dtype=dt)
        self.gru1 = GRUParams(2 * e, g, dt)
        self.augru = GRUParams(g, g, dt)
        self.att_w = _param(g, 2 * e, dtype=dt)
        self.mlp = MLPParams((g + 6 * e,) + tuple(cfg.mlp_dims) + (1,), dt)


def init_dien(cfg: DIENConfig, generator: Optional[torch.Generator] = None,
              device: DeviceLike = "cuda") -> DIEN:
    """A :class:`DIEN` on ``device`` with the reference's initial law, drawn
    from ``generator`` (a fresh one seeded 0 if None)."""
    dev = resolve_device(device)
    return init_module(DIEN(cfg), _generator(generator, dev), dev)


def dien_forward(cfg: DIENConfig, model: DIEN, batch: Dict[str, Tensor],
                 plain: bool = False) -> Tensor:
    """batch: hist_items / hist_cates (B, S), target_item / target_cate
    (B,), mask (B, S) -> logits (B,).  ``plain`` runs the scans as
    :func:`gru_scan_ref` (the plain version)."""
    hi = default_lookup(model.item_emb, batch["hist_items"])
    hc = default_lookup(model.cate_emb, batch["hist_cates"])
    h_seq = torch.cat([hi, hc], dim=-1)                      # (B, S, 2E)
    ti = default_lookup(model.item_emb, batch["target_item"])
    tc = default_lookup(model.cate_emb, batch["target_cate"])
    tgt = torch.cat([ti, tc], dim=-1)                        # (B, 2E)
    mask = batch["mask"].to(h_seq.dtype)                     # (B, S)
    if plain:
        interests = gru_scan_ref(model.gru1, h_seq, mask)
    else:
        interests = gru_scan(model.gru1, h_seq, mask)        # (B, S, G)
    # einsum("bsg,ge,be->bs"): tgt with att_w first, as XLA contracts it
    key = tgt @ model.att_w.T                                # (B, G)
    att_logits = (interests @ key[:, :, None])[:, :, 0]
    att_logits = torch.where(mask > 0, att_logits, -1e30)
    att = torch.softmax(att_logits, dim=-1)                  # (B, S)
    if plain:
        h_final = gru_scan_ref(model.augru, interests, mask, att)[:, -1]
    else:
        h_final = gru_scan(model.augru, interests, mask, att, last_only=True)
    hist_sum = (h_seq * mask[..., None]).sum(dim=1)
    z = torch.cat([h_final, tgt, hist_sum, tgt * hist_sum], dim=-1)
    return model.mlp(z)[:, 0]


def dien_loss(cfg: DIENConfig, model: DIEN, batch: Dict[str, Tensor],
              plain: bool = False) -> Tensor:
    return bce_with_logits(dien_forward(cfg, model, batch, plain),
                           batch["label"])


@torch.no_grad()
def dien_score_candidates(cfg: DIENConfig, model: DIEN,
                          batch: Dict[str, Tensor], cand_items: Tensor,
                          cand_cates: Tensor, chunk: int = 4096) -> Tensor:
    """retrieval_cand: one user (batch fields with B = 1) against (N,)
    candidates -> (N,) logits, as the reference's
    ``dien_score_candidates``: the GRU runs once; attention and the AUGRU
    run per chunk of candidates (``N // chunk`` chunks when ``chunk``
    divides N and N > chunk, else one).  Reads as the reference's: the
    history by ``table[clip(ids, 0)]`` (-1 reads row 0), the candidates by
    ``table[ids]`` (:func:`index_rows`).

    The AUGRU's input side ``interest_t @ wi + b`` is the same for every
    candidate, so it is formed once per step (the reference broadcasts
    it).  Every one of the S steps runs and a masked step keeps the state
    (``torch.where`` on the device, as the reference's scan), so nothing
    is read on the host."""
    hi = index_rows(model.item_emb, batch["hist_items"].clamp_min(0))
    hc = index_rows(model.cate_emb, batch["hist_cates"].clamp_min(0))
    h_seq = torch.cat([hi, hc], dim=-1)                      # (1, S, 2E)
    mask = batch["mask"].to(h_seq.dtype)
    interests = gru_scan(model.gru1, h_seq, mask)[0]         # (S, G)
    keep = mask[0] > 0
    gi = torch.addmm(model.augru.b, interests, model.augru.wi)   # (S, 3G)
    key = interests @ model.att_w                            # (S, 2E)
    hist_sum = (h_seq[0] * mask[0][:, None]).sum(dim=0)      # (2E,)
    n = cand_items.shape[0]
    nc = n // chunk if n % chunk == 0 and n > chunk else 1
    rows = n // nc
    scores = h_seq.new_empty(n)
    for c in range(nc):
        sl = slice(c * rows, (c + 1) * rows)
        tgt = torch.cat([index_rows(model.item_emb, cand_items[sl]),
                         index_rows(model.cate_emb, cand_cates[sl])], dim=-1)
        att_logits = torch.where(keep[None], tgt @ key.T, -1e30)   # (C, S)
        att = torch.softmax(att_logits, dim=-1).T.contiguous()     # (S, C)
        h = tgt.new_zeros((rows, cfg.gru_dim))
        for t in range(keep.shape[0]):
            h = torch.where(keep[t], _cell(gi[t], h, model.augru.wh,
                                           att[t])[0], h)
        hs = hist_sum.expand_as(tgt)
        z = torch.cat([h, tgt, hs, tgt * hs], dim=-1)
        scores[sl] = model.mlp(z)[:, 0]
    return scores


# ===========================================================================
# SASRec (arXiv:1808.09781): self-attentive sequential recommendation
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dtype: torch.dtype = torch.float32


class SASRecBlock(nn.Module):
    def __init__(self, e: int, dtype):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
            setattr(self, name, _param(e, e, dtype=dtype))
        self.ln1 = _param(e, dtype=dtype)
        self.ln2 = _param(e, dtype=dtype)


class SASRec(nn.Module):
    """Item and position tables and ``n_blocks`` single-head attention
    blocks (``blocks.i.wq``, ... ``blocks.i.ln2``), the reference's
    layouts.  Built on ``meta`` (:func:`init_sasrec`,
    ``repro_torch.convert.sasrec_params_from_arrays``)."""

    def __init__(self, cfg: SASRecConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.item_emb = _param(cfg.n_items, e, dtype=cfg.dtype)
        self.pos_emb = _param(cfg.seq_len, e, dtype=cfg.dtype)
        self.blocks = nn.ModuleList(SASRecBlock(e, cfg.dtype)
                                    for _ in range(cfg.n_blocks))


def init_sasrec(cfg: SASRecConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> SASRec:
    """A :class:`SASRec` on ``device`` with the reference's initial law."""
    dev = resolve_device(device)
    return init_module(SASRec(cfg), _generator(generator, dev), dev)


def _rms(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in ``x``'s dtype with the ``(1 + w)`` gain."""
    nrm = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * nrm * (1.0 + w)


def sasrec_forward(cfg: SASRecConfig, model: SASRec, seq: Tensor) -> Tensor:
    """seq (B, S) item ids (-1 pads) -> hidden states (B, S, E).  Masked
    logits are set to -1e30, not -inf, as in the reference: a query whose
    causal keys are all padding attends uniformly to all S keys."""
    s = seq.shape[1]
    e = cfg.embed_dim
    h = default_lookup(model.item_emb, seq) * math.sqrt(e)
    h = h + model.pos_emb[None, :s]
    causal = torch.ones((s, s), dtype=torch.bool, device=seq.device).tril()
    mask = causal[None] & (seq >= 0)[:, None, :]              # (B, S, S)
    for bp in model.blocks:
        hn = _rms(h, bp.ln1)
        q, k, v = hn @ bp.wq, hn @ bp.wk, hn @ bp.wv
        att = (q @ k.transpose(1, 2)) / math.sqrt(e)
        a = torch.softmax(torch.where(mask, att, -1e30), dim=-1)
        h = h + (a @ v) @ bp.wo
        hn = _rms(h, bp.ln2)
        h = h + torch.relu(hn @ bp.w1) @ bp.w2
    return h


def sampled_logits_ref(h: Tensor, table: Tensor, neg: Tensor) -> Tensor:
    """The plain version: ``einsum("bse,bsne->bsn", h, lookup(table,
    neg))``, the (B, S, N, E) negative embeddings held whole."""
    return torch.einsum("bse,bsne->bsn", h, default_lookup(table, neg))


class SampledLogits(torch.autograd.Function):
    """:func:`sampled_logits_ref` in blocks of ``NEG_BLOCK`` batch rows: no
    (B, S, N, E) tensor is kept.  The forward saves ``h`` and the ids; the
    backward regathers each block's rows, forms ``grad_h = sum_n g ne``
    and adds ``g h`` into the table's gradient with one ``index_add_`` a
    block.  ``default_lookup``'s semantics hold both ways: an id < 0 reads
    zeros and sends no gradient, an id >= V reads row V - 1 and sends its
    gradient there."""

    @staticmethod
    def forward(ctx, h, table, neg):
        block = NEG_BLOCK
        out = h.new_empty(neg.shape)
        for r in range(0, h.shape[0], block):
            ne = default_lookup(table, neg[r:r + block])     # (b, S, N, E)
            out[r:r + block] = (ne @ h[r:r + block, :, :, None])[..., 0]
        ctx.save_for_backward(h, table, neg)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, g):
        h, table, neg = ctx.saved_tensors
        block, v = ctx.block, table.shape[0]
        dh = torch.empty_like(h) if ctx.needs_input_grad[0] else None
        dt = torch.zeros_like(table) if ctx.needs_input_grad[1] else None
        for r in range(0, h.shape[0], block):
            ids = neg[r:r + block]
            valid = ids >= 0
            safe = ids.clamp(0, v - 1).long()
            gb = torch.where(valid, g[r:r + block], 0.0)      # (b, S, N)
            if dh is not None:
                ne = torch.where(valid[..., None], table[safe], 0.0)
                dh[r:r + block] = (gb[:, :, None, :] @ ne)[:, :, 0]
                del ne
            if dt is not None:
                src = gb[..., None] * h[r:r + block, :, None, :]
                dt.index_add_(0, safe.reshape(-1),
                              src.reshape(-1, table.shape[1]))
                del src
        return dh, dt, None


def sampled_logits(h: Tensor, table: Tensor, neg: Tensor) -> Tensor:
    """``neg_logit[b, s, n] = h[b, s] . lookup(table, neg[b, s, n])``, (B, S,
    N), through :class:`SampledLogits`."""
    return SampledLogits.apply(h, table, neg)


def sasrec_loss(cfg: SASRecConfig, model: SASRec, batch: Dict[str, Tensor],
                plain: bool = False) -> Tensor:
    """Next-item prediction with sampled negatives (the paper's BCE form):
    seq, pos (B, S), neg (B, S, N) ids.  The negatives' logits go through
    :func:`sampled_logits` (``plain``: :func:`sampled_logits_ref`)."""
    seq, pos, neg = batch["seq"], batch["pos"], batch["neg"]
    h = sasrec_forward(cfg, model, seq)
    pe = default_lookup(model.item_emb, pos)                   # (B, S, E)
    pos_logit = (h * pe).sum(dim=-1)                           # (B, S)
    neg_logit = (sampled_logits_ref(h, model.item_emb, neg) if plain
                 else sampled_logits(h, model.item_emb, neg))
    m = (pos >= 0).to(h.dtype)
    lp = F.logsigmoid(pos_logit) * m
    ln = F.logsigmoid(-neg_logit).sum(dim=-1) * m
    return -(lp + ln).sum() / m.sum().clamp_min(1.0)


# ===========================================================================
# DCN-v2 (arXiv:2008.13535): cross network v2 + deep tower
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class DCNv2Config:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    vocab_sizes: Tuple[int, ...] = tuple([1_000_000] * 20
                                         + [10_000_000] * 6)
    embed_dim: int = 16
    n_cross: int = 3
    mlp_dims: Tuple[int, ...] = (1024, 1024, 512)
    dtype: torch.dtype = torch.float32

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


class CrossParams(nn.Module):
    def __init__(self, d0: int, dtype):
        super().__init__()
        self.w = _param(d0, d0, dtype=dtype)
        self.b = _param(d0, dtype=dtype)


class DCNv2(nn.Module):
    """``n_sparse`` tables (``tables.i``), ``n_cross`` cross layers
    (``cross.i.w`` / ``.b``), the deep tower (``mlp``) and the ``head``
    (d_deep + d0, 1), the reference's layouts.  Built on ``meta``
    (:func:`init_dcnv2`, ``repro_torch.convert.dcnv2_params_from_arrays``)."""

    def __init__(self, cfg: DCNv2Config):
        super().__init__()
        self.cfg = cfg
        d0, dt = cfg.d_input, cfg.dtype
        self.tables = nn.ParameterList(_param(v, cfg.embed_dim, dtype=dt)
                                       for v in cfg.vocab_sizes)
        self.cross = nn.ModuleList(CrossParams(d0, dt)
                                   for _ in range(cfg.n_cross))
        self.mlp = MLPParams((d0,) + tuple(cfg.mlp_dims), dt)
        self.head = _param(cfg.mlp_dims[-1] + d0, 1, dtype=dt)


def init_dcnv2(cfg: DCNv2Config, generator: Optional[torch.Generator] = None,
               device: DeviceLike = "cuda") -> DCNv2:
    """A :class:`DCNv2` on ``device`` with the reference's initial law (the
    cross weights with std 0.01)."""
    dev = resolve_device(device)
    return init_module(DCNv2(cfg), _generator(generator, dev), dev,
                       {f"cross.{i}.w": 0.01 for i in range(cfg.n_cross)})


def dcnv2_interact(model: DCNv2, x0: Tensor) -> Tensor:
    """The cross layers ``x = x0 * (x @ w + b) + x`` and the deep tower on
    x0 (B, d0), then the head -> logits (B,)."""
    x = x0
    for cp in model.cross:
        x = x0 * (x @ cp.w + cp.b) + x
    deep = model.mlp(x0, final_act=True)
    return (torch.cat([x, deep], dim=-1) @ model.head)[:, 0]


def dcnv2_forward(cfg: DCNv2Config, model: DCNv2,
                  batch: Dict[str, Tensor]) -> Tensor:
    """batch: dense (B, n_dense) float, sparse (B, n_sparse) ids -> logits
    (B,)."""
    embs = [default_lookup(model.tables[i], batch["sparse"][:, i])
            for i in range(cfg.n_sparse)]
    x0 = torch.cat([batch["dense"]] + embs, dim=-1)           # (B, d0)
    return dcnv2_interact(model, x0)


def dcnv2_loss(cfg: DCNv2Config, model: DCNv2,
               batch: Dict[str, Tensor]) -> Tensor:
    return bce_with_logits(dcnv2_forward(cfg, model, batch), batch["label"])
