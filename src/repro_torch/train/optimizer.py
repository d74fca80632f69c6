"""AdamW and its learning-rate schedule, as plain functions.

The reference's arithmetic, not ``torch.optim.AdamW``'s: the gradients'
global norm is clipped with ``scale = min(1, clip / (norm + 1e-9))``, the
moments and the update run in fp32 with the bias corrections applied to
the moments, weight decay is added to the Adam direction
(``p - lr * (m̂ / (√v̂ + eps) + wd * p)``) and the result is cast back to
the parameter's dtype.  The step count, the learning rate and the clip scale
stay on the parameters' device, so an update never waits for the host.

Parameters are named tensors: an ``nn.Module``'s ``named_parameters()`` or
a flat ``{name: tensor}`` mapping.  The optimizer state keeps one fp32
``mu`` and ``nu`` per name and is updated in place, as are the parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Union

import torch
from torch import nn

from repro_torch.configs.specs import TensorSpec

Tensor = torch.Tensor
Params = Union[nn.Module, Mapping[str, Tensor]]


class AdamWState(NamedTuple):
    step: Tensor                 # () int32, on the parameters' device
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_tensors(params: Params) -> Dict[str, Tensor]:
    """``{name: tensor}`` of a module's parameters, or of a flat mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step) -> Tensor:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``, then a cosine
    decay to ``min_lr_ratio * lr`` at ``total_steps``; fp32 on ``step``'s
    device."""
    step = torch.as_tensor(step).float()
    warm = (step / max(cfg.warmup_steps, 1)).clamp_max(1.0)
    t = ((step - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_adamw(params: Params) -> AdamWState:
    """Step 0 and fp32 zero moments beside each parameter."""
    named = named_tensors(params)
    dev = next(iter(named.values())).device if named else None
    mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in named.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)


# elements of a gradient squared and summed at once by global_norm, and of
# a parameter updated at once by adamw_update
NORM_CHUNK = 1 << 26


def global_norm(grads: Mapping[str, Tensor]) -> Tensor:
    """sqrt of the sum of every gradient's squares, in fp32: each chunk of
    ``NORM_CHUNK`` elements squared and summed by ``sum`` (a tree or
    cascade sum; ``torch.dot`` on the CPU stood 4e-6 to over 1e-5 from
    float64 over 5e7 elements, ``vector_norm`` 2e-3, this 7e-8)."""
    sq = [c.float().pow(2).sum()
          for g in grads.values() for c in g.reshape(-1).split(NORM_CHUNK)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, Tensor],
                 state: AdamWState, params: Params):
    """One AdamW step over ``params`` with ``grads`` (the same names; any
    float dtype).  Updates the parameters and the moments in place and
    returns ``(params, new_state)``; ``grads`` are left as they are."""
    named = named_tensors(params)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    c1 = 1.0 - torch.pow(cfg.b1, step.float())
    c2 = 1.0 - torch.pow(cfg.b2, step.float())
    for name, p in named.items():
        parts = (p, state.mu[name], state.nu[name], grads[name])
        if all(t.is_contiguous() for t in parts[:3]):
            # NORM_CHUNK elements at a time: the fp32 scratch of a large
            # table stays small (gemma3's embedding would take 22 GB)
            parts = zip(*(t.reshape(-1).split(NORM_CHUNK) for t in parts))
        else:
            parts = (parts,)
        for pc, m, v, gc in parts:
            _adamw_elements(cfg, pc, m, v, gc, scale, lr, c1, c2)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def _adamw_elements(cfg: AdamWConfig, p: Tensor, m: Tensor, v: Tensor,
                    grad: Tensor, scale, lr, c1, c2) -> None:
    """The update of one span of elements, in place on ``p``, ``m``, ``v``
    (views of the parameter and its moments)."""
    # in the reference's order of operations; g and t are scratch
    g = grad.float() * scale
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    t = (g * (1 - cfg.b2)).mul_(g)
    v.mul_(cfg.b2).add_(t)
    torch.div(v, c2, out=t).sqrt_().add_(cfg.eps)
    torch.div(m, c1, out=g).div_(t)                      # the Adam direction
    del t
    p32 = p.float()
    g.add_(p32 * cfg.weight_decay).mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(g)
    else:
        p.copy_(p32.sub_(g))


def adamw_specs(param_specs: Mapping[str, object]) -> AdamWState:
    """The state's shapes from parameter specs (anything with ``shape``):
    the counterpart of ``jax.eval_shape(init_adamw, params)``."""
    mom = {k: TensorSpec(tuple(s.shape), torch.float32)
           for k, s in param_specs.items()}
    return AdamWState(step=TensorSpec((), torch.int32), mu=mom,
                      nu=dict(mom))
