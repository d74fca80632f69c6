"""Training launcher CLI.

Runs the fault-tolerant loop for a ported architecture at its reduced
(host-scale) config, on random but deterministic batches (numpy-seeded,
the same batches as the reference launcher's):

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch two-tower-retrieval --steps 200 --ckpt-dir ck [--device cpu]

A second run with the same ``--ckpt-dir`` resumes from its latest
checkpoint and skips the batches already consumed.  ``--device`` defaults
to ``cuda`` and raises without a card.  The loop differentiates the
arch's own loss (``arch.loss_fn``) with its AdamW, so each step updates
the weights once.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.train.loop import TrainConfig, run
from repro_torch.train.optimizer import AdamWConfig

# the arches the launcher trains: those with train cells (not acorn)
TRAIN_ARCH_IDS = [a for a in ARCH_IDS if a != "acorn"]


def _train_shape(arch) -> str:
    for c in arch.cells():
        if c.kind == "train":
            return c.shape
    raise ValueError("arch has no train cell")


def make_data_iter(arch, cfg, shape, seed=0, device="cuda"):
    """Random-but-deterministic batches matching the arch's train inputs,
    drawn from one numpy generator in the reference's order (the batch's
    keys sorted, as a JAX pytree flattens them) and law: integers in
    [0, 4), ``adj`` Bernoulli(0.3), masks and bools all ones, the rest
    standard normal."""
    _, _, batch_struct = arch.abstract_inputs(cfg, shape, reduced=True)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        batch = {}
        for name in sorted(batch_struct):
            spec = batch_struct[name]
            if spec.dtype != torch.bool and not spec.dtype.is_floating_point:
                a = rng.integers(0, 4, spec.shape)
            elif "adj" in name:
                a = rng.random(spec.shape) < 0.3
            elif "mask" in name or spec.dtype == torch.bool:
                a = np.ones(spec.shape)
            else:
                a = rng.normal(size=spec.shape)
            batch[name] = torch.as_tensor(np.asarray(a), device=dev).to(
                spec.dtype)
        yield batch


def train(arch_id: str, steps: int = 100, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, lr: float = 1e-3, microbatches: int = 1,
          device="cuda", model=None, log_every: int = 10) -> dict:
    """Train ``arch_id``'s first train cell at its reduced config and
    return :func:`repro_torch.train.loop.run`'s result.  ``model`` starts
    from given weights (on ``device``) instead of the arch's seeded init."""
    dev = resolve_device(device)
    arch = get_arch(arch_id)
    shape = _train_shape(arch)
    cfg = arch.config(reduced=True, shape=shape)
    loss_fn = arch.loss_fn(cfg, shape)
    if model is None:
        model = arch.init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    data = make_data_iter(arch, cfg, shape, device=dev)
    res = run(loss_fn, model, data,
              TrainConfig(total_steps=steps, ckpt_every=ckpt_every,
                          log_every=log_every, microbatches=microbatches,
                          ckpt_dir=ckpt_dir),
              AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=steps))
    res["shape"] = shape
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=TRAIN_ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = train(args.arch, args.steps, args.ckpt_dir, args.ckpt_every,
                args.lr, args.microbatches, args.device)
    print(f"{args.arch}/{res['shape']}: {res['steps']} steps in "
          f"{res['seconds']:.1f}s; loss {res['losses'][0][1]:.4f} -> "
          f"{res['losses'][-1][1]:.4f}")
    return res


if __name__ == "__main__":
    main()
