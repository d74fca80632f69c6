"""Config-driven decoder-only transformer covering the LM arches.

Features (selected per config), as the reference's
(``repro/models/transformer.py``):
  * GQA attention with RoPE (smollm / qwen3 / gemma3 / moonshot)
  * qk-norm (qwen3, gemma3)
  * the 5:1 local (sliding-window) : global attention pattern (gemma3)
  * MLA: multi-head latent attention with a compressed KV (``kv_lora``)
    and a decoupled shared RoPE key (deepseek-v2-lite); the cache holds
    only the latent and the rope key
  * MoE FFN with shared experts and sort-based (linear-cost) token
    dispatch into per-expert capacity buffers

A model is a :class:`Transformer` (``embed``, ``final_norm`` and a
``ModuleList`` of :class:`DecoderLayer`) with the reference's ``(in,
out)`` layouts (``x @ w``) under its tree's names, one module per layer
where the reference stacks ``(L, ...)`` arrays
(``repro_torch.convert.lm_params_from_arrays`` slices them).  Layers run
in a Python loop, each under a non-reentrant checkpoint when ``remat`` is
set and grad is on.

Attention is plain torch in fp32 (q, k and v upcast), masked with -1e30
(a fully masked row goes uniform) and, with ``attn_chunk``, looped over
query chunks so that one chunk's scores are live at a time.  The decode
and prefill caches are preallocated (L, B, Smax, ...) tensors that the
layers write in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from .common import (apply_rope, cross_entropy, rms_norm, set_named_params,
                     source_rows, swiglu)

Tensor = torch.Tensor
Cache = Tuple[Tensor, Tensor]
Pos = Union[int, Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    rope_theta: float = 1e4
    # local:global pattern: every (local_ratio+1)-th layer is global; 0 = all
    # layers global full attention
    window: int = 0
    local_ratio: int = 0
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    # MLA (kv_lora > 0 -> MLA attention; n_kv_heads ignored)
    kv_lora: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attn_chunk: int = 0      # >0: loop attention over query chunks (long S)
    logits_f32: bool = True  # False: keep the logits in ``dtype``

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora > 0

    def layer_is_global(self) -> Tensor:
        """(n_layers,) bool on the CPU: which layers attend globally."""
        if self.local_ratio <= 0 or self.window <= 0:
            return torch.ones((self.n_layers,), dtype=torch.bool)
        idx = torch.arange(self.n_layers)
        return (idx + 1) % (self.local_ratio + 1) == 0

    def param_count(self) -> int:
        c = self
        emb = c.vocab * c.d_model
        if c.is_mla:
            hd = c.head_dim + c.rope_head_dim
            attn = (c.d_model * c.n_heads * hd            # wq
                    + c.d_model * (c.kv_lora + c.rope_head_dim)
                    + c.kv_lora * c.n_heads * (c.head_dim + self.vdim())
                    + c.n_heads * self.vdim() * c.d_model)
        else:
            attn = (c.d_model * c.n_heads * c.head_dim
                    + 2 * c.d_model * c.n_kv_heads * c.head_dim
                    + c.n_heads * c.head_dim * c.d_model)
        if c.is_moe:
            ffn = (c.d_model * c.n_experts
                   + 3 * c.n_experts * c.d_model * c.d_expert
                   + 3 * c.n_shared * c.d_model * c.d_expert)
        else:
            ffn = 3 * c.d_model * c.d_ff
        return emb + c.n_layers * (attn + ffn + 2 * c.d_model) + c.d_model

    def active_param_count(self) -> int:
        """6·N_active·D MoE convention: experts count at top_k + shared."""
        if not self.is_moe:
            return self.param_count()
        c = self
        full = self.param_count()
        all_experts = 3 * c.n_experts * c.d_model * c.d_expert
        active = 3 * c.top_k * c.d_model * c.d_expert
        return full - c.n_layers * (all_experts - active)

    def vdim(self) -> int:
        return self.v_head_dim or self.head_dim


# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))


class DecoderLayer(nn.Module):
    """One layer's weights under the reference's names: ``ln1``, ``ln2``;
    GQA ``wq``, ``wk``, ``wv``, ``wo`` or MLA ``wq``, ``w_dkv``, ``w_uk``,
    ``w_uv``, ``wo``; ``q_norm`` / ``k_norm`` with qk-norm; a dense
    ``w_gate``, ``w_up``, ``w_down`` or the MoE ``router``, experts
    ``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f, d) and the shared
    ``ws_gate``, ``ws_up``, ``ws_down``.  Built on ``meta``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        h, hd = cfg.n_heads, cfg.head_dim
        self.ln1 = _param(d, dtype=dt)
        self.ln2 = _param(d, dtype=dt)
        if cfg.is_mla:
            r, hr = cfg.kv_lora, cfg.rope_head_dim
            self.wq = _param(d, h * (hd + hr), dtype=dt)
            self.w_dkv = _param(d, r + hr, dtype=dt)
            self.w_uk = _param(r, h * hd, dtype=dt)
            self.w_uv = _param(r, h * cfg.vdim(), dtype=dt)
            self.wo = _param(h * cfg.vdim(), d, dtype=dt)
        else:
            kv = cfg.n_kv_heads
            self.wq = _param(d, h * hd, dtype=dt)
            self.wk = _param(d, kv * hd, dtype=dt)
            self.wv = _param(d, kv * hd, dtype=dt)
            self.wo = _param(h * hd, d, dtype=dt)
        if cfg.qk_norm:
            self.q_norm = _param(hd, dtype=dt)
            self.k_norm = _param(hd, dtype=dt)
        if cfg.is_moe:
            e, f = cfg.n_experts, cfg.d_expert
            self.router = _param(d, e, dtype=dt)
            self.w_gate = _param(e, d, f, dtype=dt)
            self.w_up = _param(e, d, f, dtype=dt)
            self.w_down = _param(e, f, d, dtype=dt)
            if cfg.n_shared:
                sd = cfg.n_shared * f
                self.ws_gate = _param(d, sd, dtype=dt)
                self.ws_up = _param(d, sd, dtype=dt)
                self.ws_down = _param(sd, d, dtype=dt)
        else:
            self.w_gate = _param(d, cfg.d_ff, dtype=dt)
            self.w_up = _param(d, cfg.d_ff, dtype=dt)
            self.w_down = _param(cfg.d_ff, d, dtype=dt)


class Transformer(nn.Module):
    """The tied ``embed`` (V, d), ``final_norm`` (d,) and ``n_layers``
    :class:`DecoderLayer` (``layers.i.wq``, ...).  Built on ``meta``
    (:func:`init_lm`, ``repro_torch.convert.lm_params_from_arrays``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(cfg.vocab, cfg.d_model, dtype=cfg.dtype)
        self.final_norm = _param(cfg.d_model, dtype=cfg.dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.n_layers))


def init_lm(cfg: TransformerConfig,
            generator: Optional[torch.Generator] = None,
            device: DeviceLike = "cuda") -> Transformer:
    """A :class:`Transformer` on ``device`` with the reference's initial
    law: the embedding N(0, 0.02^2), every matrix N(0, 1/fan_in) (fan_in
    the second-to-last axis: d_in of a (d_in, d_out) matrix, of each
    expert's (d_in, d_out) and ``kv_lora`` for ``w_uk`` / ``w_uv``), norms
    zeros.  Each tensor is drawn from ``generator`` (on ``device``) in
    fp32, one layer's at a time, and cast to ``cfg.dtype``: no stacked
    fp32 draw (gemma3's would hold 28.7 GB for ``w_gate`` alone).
    Parameters do not require grad."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    model = Transformer(cfg)
    named: Dict[str, Tensor] = {}
    for name, p in model.named_parameters():
        if p.dim() == 1:
            named[name] = torch.zeros(p.shape, dtype=p.dtype, device=dev)
            continue
        std = 0.02 if name == "embed" else 1.0 / math.sqrt(p.shape[-2])
        w = torch.empty(p.shape, dtype=torch.float32, device=dev)
        named[name] = w.normal_(0.0, std, generator=generator).to(p.dtype)
        del w
    return set_named_params(model, named)


def embed_tokens(embed: Tensor, tokens: Tensor) -> Tensor:
    """``embed[tokens]`` as the reference's ``jnp`` indexing reads it (a
    negative id wraps once; an id still outside [0, V) reads the nearest
    end row and passes no gradient), gathered with ``F.embedding``: the
    CUDA backward of ``embed[tokens]`` walks a row's repeats one by one
    (``repro_torch.models.recsys.default_lookup``)."""
    read, write = source_rows(tokens, embed.shape[0])
    rows = F.embedding(read, embed)
    if rows.requires_grad:
        keep = (write < embed.shape[0])[..., None]
        rows = torch.where(keep, rows, rows.detach())
    return rows


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _causal_mask(s: int, window: int = 0, device=None) -> Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (i - j < window)
    return m  # (S, S)


def _attention_core(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
                    scale: float, chunk: int = 0) -> Tensor:
    """Grouped-KV attention without repeating heads, in fp32 (float64
    stays float64).

    q (B,Sq,H,hdk), k (B,Sk,KV,hdk), v (B,Sk,KV,hdv), mask (1|B,1,Sq,Sk)
    -> (B,Sq,H,hdv).  Scores are ``scale * q.k`` where the mask is set and
    -1e30 elsewhere, then softmax over Sk.  With ``chunk`` > 0 dividing Sq
    (and below it) the queries are taken ``chunk`` at a time, so the live
    scores are (B,KV,G,chunk,Sk), the reference's ``lax.map`` shape."""
    b, sq, h, hdk = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    ct = torch.promote_types(q.dtype, torch.float32)
    # (B*KV, Sk, hd): one upcast copy each, laid out for batched products
    kf = k.transpose(1, 2).to(ct, memory_format=torch.contiguous_format
                              ).reshape(b * kv, sk, hdk)
    vf = v.transpose(1, 2).to(ct, memory_format=torch.contiguous_format
                              ).reshape(b * kv, sk, -1)
    hdv = vf.shape[-1]
    qg = q.reshape(b, sq, kv, g, hdk).permute(0, 2, 3, 1, 4)  # (B,KV,G,Sq,hd)
    drop = ~mask[:, :, None]                            # (1|B,1,1,Sq,Sk)
    none = q.new_zeros((), dtype=ct)

    def block(q0: int, q1: int) -> Tensor:
        c = q1 - q0
        qc = qg[:, :, :, q0:q1].to(ct).reshape(b * kv, g * c, hdk)
        # beta = 0: ``none`` is ignored, the product is scaled as it lands
        s = torch.baddbmm(none, qc, kf.transpose(1, 2), beta=0.0,
                          alpha=scale)
        s.view(b, kv, g, c, sk).masked_fill_(drop[..., q0:q1, :], -1e30)
        p = torch.softmax(s, dim=-1)
        del s
        return torch.bmm(p, vf).view(b, kv, g, c, hdv)

    if chunk and sq > chunk and sq % chunk == 0:
        out = torch.cat([block(q0, q0 + chunk)
                         for q0 in range(0, sq, chunk)], dim=3)
    else:
        out = block(0, sq)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hdv)


def _write_cache(c: Tensor, new: Tensor, pos: Pos) -> None:
    """``c`` (B, Smax, ...) gets ``new`` (B, s, ...) at rows [start, start
    + s), in place.  ``start`` is ``pos`` clamped to [0, Smax - s], as
    ``lax.dynamic_update_slice`` clamps its start: a write at pos > Smax -
    s lands at Smax - s (a reference quirk)."""
    smax, s = c.shape[1], new.shape[1]
    if isinstance(pos, int):
        start = min(max(pos, 0), smax - s)
        c[:, start:start + s] = new
        return
    idx = pos.clamp(0, smax - s).long() + torch.arange(s, device=c.device)
    c.index_copy_(1, idx, new)


def gqa_attention(cfg: TransformerConfig, lp: DecoderLayer, x: Tensor,
                  mask: Tensor, positions: Tensor,
                  cache: Optional[Cache] = None,
                  cache_pos: Optional[Pos] = None):
    """x (B,S,D); mask (1|B,1,S,Skv) bool; returns (out, cache).  A
    ``cache`` (B, Smax, KV, hd) pair is written in place at ``cache_pos``
    and returned as it is; attention then spans all Smax rows."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp.wq).reshape(b, s, h, hd)
    k = (x @ lp.wk).reshape(b, s, kv, hd)
    v = (x @ lp.wv).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp.q_norm)
        k = rms_norm(k, lp.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        _write_cache(cache[0], k, cache_pos)
        _write_cache(cache[1], v, cache_pos)
        k, v = cache
    out = _attention_core(q, k, v, mask, 1.0 / math.sqrt(hd),
                          chunk=cfg.attn_chunk)
    out = out.reshape(b, s, h * hd).to(x.dtype)
    return out @ lp.wo, cache


def mla_attention(cfg: TransformerConfig, lp: DecoderLayer, x: Tensor,
                  mask: Tensor, positions: Tensor,
                  cache: Optional[Cache] = None,
                  cache_pos: Optional[Pos] = None):
    """DeepSeek-V2 MLA: a latent-compressed KV and a decoupled shared RoPE
    key.  ``cache`` = (c_kv (B,Smax,r), k_rope (B,Smax,1,hd_r)), the
    compressed form, written in place; every call decompresses the keys
    and values of all its rows through ``w_uk`` / ``w_uv``."""
    b, s, _ = x.shape
    h, hd, hr, vd, r = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                        cfg.vdim(), cfg.kv_lora)
    q = (x @ lp.wq).reshape(b, s, h, hd + hr)
    q_rope = apply_rope(q[..., hd:], positions, cfg.rope_theta)
    q = torch.cat([q[..., :hd], q_rope], dim=-1)

    dkv = x @ lp.w_dkv                                 # (B,S,r+hr)
    c_kv, k_rope = dkv[..., :r], dkv[..., r:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    if cache is not None:
        _write_cache(cache[0], c_kv, cache_pos)
        _write_cache(cache[1], k_rope, cache_pos)
        c_kv, k_rope = cache

    # per-head keys and values from the latent; the shared rope key joins
    # each head's key, so the grouped core sees one (hd + hr)-wide key
    k_nope = (c_kv @ lp.w_uk).reshape(b, -1, h, hd)
    k_full = torch.cat([k_nope, k_rope.expand(-1, -1, h, -1)], dim=-1)
    v = (c_kv @ lp.w_uv).reshape(b, -1, h, vd)
    out = _attention_core(q, k_full, v, mask, 1.0 / math.sqrt(hd + hr),
                          chunk=cfg.attn_chunk)
    out = out.reshape(b, s, h * vd).to(x.dtype)
    return out @ lp.wo, cache


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------


def dense_ffn(lp: DecoderLayer, x: Tensor) -> Tensor:
    return swiglu(x, lp.w_gate, lp.w_up, lp.w_down)


def moe_route(cfg: TransformerConfig, lp: DecoderLayer, xf: Tensor):
    """Router of (T, D) tokens: (T, k) gate weights (softmax in fp32,
    renormalised over the top k) and (T, k) expert ids, the top k taken
    lower id first on ties, as ``lax.top_k`` (``torch.topk`` promises no
    order among ties, and bf16 router logits tie at full width)."""
    ct = torch.promote_types(xf.dtype, torch.float32)
    gates = torch.softmax((xf @ lp.router).to(ct), dim=-1)
    topw, topi = gates.sort(dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return topw, topi


def moe_ffn(cfg: TransformerConfig, lp: DecoderLayer, x: Tensor) -> Tensor:
    """Sort-based token dispatch MoE (linear cost, no one-hot matmul).

    x (B,S,D) -> (B,S,D).  Assignments are sorted by expert (stably), each
    expert takes its first C = ceil(T·top_k/E·capacity_factor) into a
    capacity buffer and drops the rest (GShard semantics, the reference's
    ``mode="drop"``); shared experts see every token.  A token's k
    weighted outputs are summed in one fixed order (back in (T, k, D),
    over k), never by atomic adds, so the forward gives the same bits on
    every run."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(t * k / e * cfg.capacity_factor))
    xf = x.reshape(t, d)
    dev = x.device

    topw, topi = moe_route(cfg, lp, xf)
    flat_e = topi.reshape(-1)                          # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_e]
    tok = order // k
    ok = pos_in_e < cap

    # overflowed assignments land in a spare last row, which is cut off
    slot = torch.where(ok, sorted_e * cap + pos_in_e, e * cap)
    buf = xf.new_zeros((e * cap + 1, d))
    buf[slot] = F.embedding(tok, xf)
    buf = buf[:-1].view(e, cap, d)

    g = F.silu(torch.bmm(buf, lp.w_gate))
    u = torch.bmm(buf, lp.w_up)
    hid = torch.bmm(g * u, lp.w_down)                  # (E, C, D)

    vals = F.embedding(sorted_e * cap + pos_in_e.clamp_max(cap - 1),
                       hid.reshape(e * cap, d))        # (T*k, D)
    w_sorted = topw.reshape(-1)[order]
    vals = (vals * (w_sorted * ok)[:, None]).to(x.dtype)
    # back to (token, choice) order, then each token's k summed over k
    out = vals[torch.argsort(order)].view(t, k, d).sum(dim=1)

    if cfg.n_shared:
        out = out + swiglu(xf, lp.ws_gate, lp.ws_up, lp.ws_down)
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _layer_apply(cfg: TransformerConfig, lp: DecoderLayer, x: Tensor,
                 mask_global: Tensor, mask_local: Tensor, is_global: bool,
                 positions: Tensor, cache: Optional[Cache] = None,
                 cache_pos: Optional[Pos] = None):
    mask = mask_global if is_global else mask_local
    attn = mla_attention if cfg.is_mla else gqa_attention
    a, new_cache = attn(cfg, lp, rms_norm(x, lp.ln1), mask, positions,
                        cache, cache_pos)
    x = x + a
    hn = rms_norm(x, lp.ln2)
    f = moe_ffn(cfg, lp, hn) if cfg.is_moe else dense_ffn(lp, hn)
    return x + f, new_cache


def _layer_out(cfg, lp, x, mask_global, mask_local, is_global, positions):
    return _layer_apply(cfg, lp, x, mask_global, mask_local, is_global,
                        positions)[0]


def _logits(cfg: TransformerConfig, model: Transformer, x: Tensor,
            upcast: bool) -> Tensor:
    """The tied head: ``x @ embed.T`` in ``cfg.dtype``, then, with
    ``upcast``, in fp32 (float64 stays float64)."""
    logits = x @ model.embed.T.to(cfg.dtype)
    if upcast:
        return logits.to(torch.promote_types(logits.dtype, torch.float32))
    return logits


def forward(cfg: TransformerConfig, model: Transformer,
            tokens: Tensor) -> Tensor:
    """tokens (B,S) -> logits (B,S,V): the training / prefill path."""
    b, s = tokens.shape
    dev = tokens.device
    x = embed_tokens(model.embed, tokens).to(cfg.dtype)
    positions = torch.arange(s, device=dev).expand(b, s)
    mg = _causal_mask(s, device=dev)[None, None]
    ml = _causal_mask(s, cfg.window, dev)[None, None] if cfg.window else mg
    remat = cfg.remat and torch.is_grad_enabled()
    for lp, g in zip(model.layers, cfg.layer_is_global().tolist()):
        if remat:
            x = checkpoint(_layer_out, cfg, lp, x, mg, ml, g, positions,
                           use_reentrant=False)
        else:
            x = _layer_out(cfg, lp, x, mg, ml, g, positions)
    x = rms_norm(x, model.final_norm)
    return _logits(cfg, model, x, cfg.logits_f32)


def lm_loss(cfg: TransformerConfig, model: Transformer, tokens: Tensor,
            labels: Tensor) -> Tensor:
    return cross_entropy(forward(cfg, model, tokens), labels)


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda") -> Cache:
    """Zeroed (L, B, Smax, ...) cache pair in ``cfg.dtype``: MLA's latent
    (.., kv_lora) and rope key (.., 1, rope_head_dim), else K and V (..,
    KV, head_dim)."""
    dev = resolve_device(device)
    L, dt = cfg.n_layers, cfg.dtype
    if cfg.is_mla:
        return (torch.zeros((L, batch, max_seq, cfg.kv_lora), dtype=dt,
                            device=dev),
                torch.zeros((L, batch, max_seq, 1, cfg.rope_head_dim),
                            dtype=dt, device=dev))
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def decode_step(cfg: TransformerConfig, model: Transformer, cache: Cache,
                tokens: Tensor, pos: Pos):
    """One-token decode: tokens (B,1) at position ``pos`` (an int or a ()
    integer tensor, on the tokens' device for a step that never waits for
    the host).  Writes the step's keys and values into ``cache`` (the
    stacked (L, B, Smax, ...) pair) in place, at ``pos`` clamped as
    :func:`_write_cache` says, and attends all Smax rows under the mask
    ``j <= pos`` (and the window on local layers).  Returns (logits (B,V)
    fp32, ``cache``)."""
    b = tokens.shape[0]
    dev = tokens.device
    smax = cache[0].shape[2]
    x = embed_tokens(model.embed, tokens).to(cfg.dtype)   # (B,1,D)
    pos = torch.as_tensor(pos, device=dev)
    positions = pos.reshape(1, 1).expand(b, 1)
    j = torch.arange(smax, device=dev)
    mask_g = (j <= pos)[None, None, None, :]
    if cfg.window:
        mask_l = mask_g & (pos - j < cfg.window)[None, None, None, :]
    else:
        mask_l = mask_g
    flags = cfg.layer_is_global().tolist()
    for i, (lp, g) in enumerate(zip(model.layers, flags)):
        x, _ = _layer_apply(cfg, lp, x, mask_g, mask_l, g, positions,
                            cache=(cache[0][i], cache[1][i]), cache_pos=pos)
    x = rms_norm(x, model.final_norm)
    return _logits(cfg, model, x[:, 0], True), cache


def prefill(cfg: TransformerConfig, model: Transformer, tokens: Tensor,
            max_seq: int):
    """Run the whole prompt, filling a new (L, B, max_seq, ...) cache in
    place (rows [0, S)); attention runs against the max_seq-long cache.
    Returns (last-token logits (B,V) fp32, cache)."""
    b, s = tokens.shape
    dev = tokens.device
    x = embed_tokens(model.embed, tokens).to(cfg.dtype)
    positions = torch.arange(s, device=dev).expand(b, s)
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(max_seq, device=dev)[None, :]
    mg = (j <= i)[None, None]
    ml = ((j <= i) & (i - j < cfg.window))[None, None] if cfg.window else mg
    cache = init_cache(cfg, b, max_seq, dev)
    flags = cfg.layer_is_global().tolist()
    for li, (lp, g) in enumerate(zip(model.layers, flags)):
        x, _ = _layer_apply(cfg, lp, x, mg, ml, g, positions,
                            cache=(cache[0][li], cache[1][li]), cache_pos=0)
    x = rms_norm(x, model.final_norm)
    return _logits(cfg, model, x[:, -1], True), cache
