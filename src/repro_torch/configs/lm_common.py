"""Shared machinery for the LM-family architectures.

Each LM arch supports the assigned shapes:
  train_4k     seq 4096,   global_batch 256   (train_step)
  prefill_32k  seq 32768,  global_batch 32    (serve: prefill)
  decode_32k   cache 32768, global_batch 128  (serve: one-token decode)
  long_500k    cache 524288, global_batch 1   (decode; sub-quadratic archs
                                               only: full-attention archs
                                               skip per assignment rules)

:class:`CellDef`, :class:`TensorSpec` and :func:`param_specs`, shared by
every arch, live in ``configs/specs.py`` and are re-exported here.  The LM
mesh rules (``in_shardings``) decide each parameter's spec with
``distributed.sharding.lm_param_spec`` on the reference's stacked (L, ...)
name and shape, then drop the layer dim for the port's per-layer tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (P, lm_param_spec,
                                              stacked_layout,
                                              tree_param_specs)
from repro_torch.models.transformer import (Transformer, TransformerConfig,
                                            decode_step, init_cache, init_lm,
                                            lm_loss, prefill)
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_specs)

from .specs import CellDef, TensorSpec, param_specs

__all__ = ["CellDef", "LMArch", "LM_SHAPES", "REDUCED_SHAPES", "TensorSpec",
           "model_flops", "param_specs"]

LM_SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

REDUCED_SHAPES: Dict[str, Dict] = {
    "train_4k": dict(kind="train", seq=32, batch=4),
    "prefill_32k": dict(kind="prefill", seq=32, batch=2),
    "decode_32k": dict(kind="decode", seq=32, batch=4),
    "long_500k": dict(kind="decode", seq=64, batch=1),
}


class LMArch:
    family = "lm"

    def __init__(self, name: str, full: TransformerConfig,
                 reduced: TransformerConfig,
                 long_ctx_skip: Optional[str] = None,
                 kv_shardable: bool = True):
        self.name = name
        self._full = full
        self._reduced = reduced
        self._long_skip = long_ctx_skip
        self._kv_shardable = kv_shardable
        self.opt = AdamWConfig()

    # ------------------------------------------------------------------
    def config(self, reduced: bool = False,
               shape: Optional[str] = None) -> TransformerConfig:
        del shape  # LM configs are shape-independent
        return self._reduced if reduced else self._full

    def cells(self):
        out = []
        for shape, spec in LM_SHAPES.items():
            skip = self._long_skip if shape == "long_500k" else None
            out.append(CellDef(shape, spec["kind"], skip))
        return out

    def module(self, cfg: TransformerConfig) -> Transformer:
        """The arch's model, on the ``meta`` device (nothing allocated)."""
        return Transformer(cfg)

    def init(self, cfg: TransformerConfig,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> Transformer:
        return init_lm(cfg, generator, device)

    def abstract_params(self, cfg: TransformerConfig
                        ) -> Dict[str, TensorSpec]:
        return param_specs(self.module(cfg))

    # ------------------------------------------------------------------
    def loss_fn(self, cfg: TransformerConfig, shape: str) -> Callable:
        """``train`` cells: ``loss(model, batch)`` (``lm_loss`` of
        ``batch["tokens"]`` against ``batch["labels"]``)."""
        if LM_SHAPES[shape]["kind"] != "train":
            raise ValueError(f"{shape} is not a train cell")
        return lambda model, batch: lm_loss(cfg, model, batch["tokens"],
                                            batch["labels"])

    def step_fn(self, cfg: TransformerConfig, shape: str) -> Callable:
        """``train``: (model, opt_state, batch) -> (model, opt_state, loss),
        one AdamW step with ``self.opt``, in place.  ``prefill``: (model,
        {tokens}) -> (last logits, cache), the cache as long as the prompt.
        ``decode``: (model, cache, {tokens (B,1), pos}) -> (logits, cache),
        the cache written in place.  Serving runs without grad."""
        kind = LM_SHAPES[shape]["kind"]
        if kind == "train":
            return make_train_step(self.loss_fn(cfg, shape), self.opt)
        if kind == "prefill":
            @torch.no_grad()
            def pre(model, batch):
                return prefill(cfg, model, batch["tokens"],
                               max_seq=batch["tokens"].shape[1])
            return pre

        @torch.no_grad()
        def dec(model, cache, batch):
            return decode_step(cfg, model, cache, batch["tokens"],
                               batch["pos"])
        return dec

    # ------------------------------------------------------------------
    def abstract_inputs(self, cfg: TransformerConfig, shape: str,
                        reduced: bool = False):
        spec = (REDUCED_SHAPES if reduced else LM_SHAPES)[shape]
        b, s = spec["batch"], spec["seq"]
        kind = spec["kind"]
        tok = TensorSpec((b, s), torch.int32)
        params = self.abstract_params(cfg)
        if kind == "train":
            return (params, adamw_specs(params),
                    {"tokens": tok, "labels": tok})
        if kind == "prefill":
            return (params, {"tokens": tok})
        cache = tuple(TensorSpec(tuple(c.shape), c.dtype)
                      for c in init_cache(cfg, b, s, device="meta"))
        return (params, cache,
                {"tokens": TensorSpec((b, 1), torch.int32),
                 "pos": TensorSpec((), torch.int32)})

    # ------------------------------------------------------------------
    def in_shardings(self, cfg, shape: str, mesh, layout: str = "baseline"):
        """The reference's specs of the cell's step arguments, the
        parameters keyed by the port's names.

        layout='baseline': FSDP+TP 2-D weight sharding (MaxText-style).
        layout='pure_dp': batch over EVERY mesh axis, weights replicated —
        the right call for sub-1B models whose TP matmuls are too small to
        amortize (the smollm finding).  The batch is split only where the
        cell's batch divides the axes; the moments take their parameter's
        spec; the decode cache (the (L, B, Smax, ...) stack, as the
        reference's) by the arch's KV divisibility, the sequence on the
        data-parallel axes at batch 1 (long_500k)."""
        kind = LM_SHAPES[shape]["kind"]
        b = LM_SHAPES[shape]["batch"]
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        dp_total = 1
        for a in dp_axes:
            dp_total *= sizes[a]
        dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        bspec = dp if b % dp_total == 0 and b >= dp_total else None

        params = self.abstract_params(cfg)
        if layout == "pure_dp":
            all_axes = tuple(mesh.axis_names)
            n_dev = mesh.size
            bspec = all_axes if (b % n_dev == 0 and b >= n_dev) else bspec
            pspecs = {k: P(*([None] * len(s.shape)))
                      for k, s in params.items()}
        else:
            pspecs = tree_param_specs(params, mesh, lm_param_spec,
                                      stacked_layout(cfg.n_layers))
        if kind == "train":
            # moments shard exactly like their params
            opt_specs = AdamWState(step=P(), mu=pspecs, nu=pspecs)
            return (pspecs, opt_specs,
                    {"tokens": P(bspec, None), "labels": P(bspec, None)})
        if kind == "prefill":
            return (pspecs, {"tokens": P(bspec, None)})
        # decode: cache sharding depends on the arch's KV divisibility
        if cfg.is_mla:
            if bspec is not None:
                c_spec = (P(None, bspec, "model", None),
                          P(None, bspec, "model", None, None))
            else:
                c_spec = (P(None, None, "model", None),
                          P(None, None, "model", None, None))
        elif self._kv_shardable:
            if bspec is not None:
                c_spec = (P(None, bspec, None, "model", None),) * 2
            else:  # long_500k: batch=1 -> sequence goes on the data axes
                c_spec = (P(None, None, dp, "model", None),) * 2
        else:
            if bspec is not None:
                c_spec = (P(None, bspec, "model", None, None),) * 2
            else:
                c_spec = (P(None, None, dp, None, None),) * 2
        return (pspecs, c_spec,
                {"tokens": P(bspec, None), "pos": P()})


def model_flops(cfg: TransformerConfig, tokens: int,
                train: bool = False) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); forward-only = 2·N·D."""
    n = cfg.active_param_count()
    per_tok = 6.0 * n if train else 2.0 * n
    return per_tok * tokens
