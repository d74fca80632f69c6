"""Training loop: grad accumulation, checkpoint/restart, fault tolerance.

The loop receives a loss function and the parameters (an ``nn.Module`` or
a flat ``{name: tensor}`` mapping) and handles the operational concerns:
resume from the latest checkpoint, periodic (async) checkpoints,
deterministic data skipping on restart and a NaN-loss circuit breaker.
The loss is read on the host only on logged steps, so the other steps
never wait for the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from .optimizer import (AdamWConfig, AdamWState, adamw_update, init_adamw,
                        named_tensors)


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 300
    ckpt_every: int = 100
    log_every: int = 10
    microbatches: int = 1      # grad accumulation factor
    ckpt_dir: Optional[str] = None
    async_ckpt: bool = True


@contextlib.contextmanager
def trainable(tensors):
    """Turn grad on for ``tensors`` (leaf parameters) inside the block and
    give each back its ``requires_grad`` after it, so a model that serves
    afterwards stays grad-free."""
    before = [t.requires_grad for t in tensors]
    try:
        for t in tensors:
            t.requires_grad_(True)
        yield
    finally:
        for t, rg in zip(tensors, before):
            t.requires_grad_(rg)


def _split(batch, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a (nested dict / list of) tensors: the
    i-th equal slice of each leading axis."""
    if isinstance(batch, dict):
        return {k: _split(v, n, i) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_split(v, n, i) for v in batch)
    size = batch.shape[0] // n
    return batch[i * size:(i + 1) * size]


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, {name: grad})`` of ``loss_fn(params, batch)`` over every
    parameter, grad turned on for the call only.  A parameter the loss does
    not use gets a zero gradient, as under ``jax.value_and_grad`` (PNA's
    minibatch step leaves its layers beyond the sampled blocks out)."""
    named = named_tensors(params)
    leaves = list(named.values())
    with torch.enable_grad(), trainable(leaves):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), dict(zip(named, grads))


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """``loss_fn(params, batch) -> scalar``.  Returns
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``, which
    updates the parameters and the state in place.

    With ``microbatches > 1`` the batch's leading axis is split into that
    many equal parts, gradients accumulate in fp32 and are divided by
    their count, as is the loss."""

    def step(params, opt_state: AdamWState, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            named = named_tensors(params)
            dev = next(iter(named.values())).device
            loss = torch.zeros((), device=dev)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            for i in range(microbatches):
                l, g = value_and_grad(loss_fn, params,
                                      _split(batch, microbatches, i))
                loss = loss + l
                for k, v in g.items():
                    grads[k].add_(v.float())
            loss = loss / microbatches
            for v in grads.values():
                v.div_(microbatches)
        params, opt_state = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state, loss

    return step


def run(loss_fn: Callable, params: Any, data_iter: Iterator,
        cfg: TrainConfig, opt_cfg: AdamWConfig) -> Dict[str, Any]:
    """Run (or resume) training.  Returns a dict with the final
    ``params`` and ``opt_state``, ``losses`` ((step, loss) on logged
    steps), ``seconds`` and the ``steps`` run."""
    step_fn = make_train_step(loss_fn, opt_cfg, cfg.microbatches)
    opt_state = init_adamw(params)
    start = 0
    mgr = None
    if cfg.ckpt_dir:
        mgr = CheckpointManager(cfg.ckpt_dir, keep=3,
                                async_save=cfg.async_ckpt)
        latest = mgr.latest_step()
        if latest is not None:
            saved = (named_tensors(params), opt_state)
            (p_ck, o_ck), _ = mgr.restore(saved, latest)
            with torch.no_grad():
                for dst, src in ((saved[0], p_ck), (opt_state.mu, o_ck.mu),
                                 (opt_state.nu, o_ck.nu)):
                    for k, t in dst.items():
                        t.copy_(src[k])
                opt_state.step.copy_(o_ck.step)
            start = latest
            # deterministic resume: skip consumed batches
            for _ in range(start):
                next(data_iter)

    losses = []
    t0 = time.perf_counter()
    for it in range(start, cfg.total_steps):
        batch = next(data_iter)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if it % cfg.log_every == 0 or it == cfg.total_steps - 1:
            val = float(loss)
            losses.append((it, val))
            if not np.isfinite(val):
                raise FloatingPointError(f"loss diverged at step {it}: {val}")
        if mgr and (it + 1) % cfg.ckpt_every == 0:
            mgr.save(it + 1, (named_tensors(params), opt_state))
    if mgr:
        mgr.save(cfg.total_steps, (named_tensors(params), opt_state))
        mgr.wait()
    wall = time.perf_counter() - t0
    return dict(params=params, opt_state=opt_state, losses=losses,
                seconds=wall, steps=cfg.total_steps - start)
