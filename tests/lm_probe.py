"""The ``train_4k`` losses of ``chip_smoke.py``'s ``lm`` part beside the
same steps in fp32 and at half the learning rate, on one card; or the
``lm`` part alone.

At FULL width the part's ``train_4k`` cell takes one warm-up and three
counted AdamW steps (the reference's defaults: the learning rate warms up
by 3e-6 a step) on one batch.  For each arch named, from that cell's own
weights (its seeded bf16 draw) and batch (its Zipf(1.1) tokens), ``--steps``
steps after the warm-up in four runs:

- ``bf16``: the cell's own steps;
- ``bf16_half_lr``: the same at half the learning rate;
- ``fp32``: the same bf16 weights upcast to fp32;
- ``fp32_half_lr``: both.

After the warm-up step, the bf16 run's parameters are held against the
fp32 run's rounded to bf16: the share of entries each step moved and the
share where the two differ (a bf16 fault in the step would show there).
Needs a CUDA card:

    PYTHONPATH=src:tests python tests/lm_probe.py [--steps 5] [--arches ID ...]
    PYTHONPATH=src:tests python tests/lm_probe.py --part | --parity

``--part`` runs ``chip_smoke.lm_phases`` alone (~3 min), ``--parity`` its
step-1 parity of each arch (~1.5 min).  ``--arches`` defaults to qwen3-8b
and gemma3-27b.  The last line of the output is one JSON object with every
number.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models.common import set_named_params
from repro_torch.train import init_adamw
from repro_torch.train.loop import make_train_step

RUNS = {"bf16": (False, 1.0), "fp32": (True, 1.0),
        "bf16_half_lr": (False, 0.5), "fp32_half_lr": (True, 0.5)}


def chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host(model) -> dict:
    return {k: p.detach().cpu() for k, p in model.named_parameters()}


def moved(model, w0: dict, w1: dict) -> dict:
    """Entries of ``model``'s parameters (rounded to bf16) that differ
    from ``w0`` and from ``w1`` (host bf16 copies), in all and in the
    tensor where the share differing from ``w1`` is largest."""
    total = changed = differ = 0
    worst = (0.0, None)
    for k, p in model.named_parameters():
        r = p.detach().to(torch.bfloat16)
        a, b = w0[k].to(r.device), w1[k].to(r.device)
        d = int((r != b).sum())
        total += r.numel()
        changed += int((r != a).sum())
        differ += d
        worst = max(worst, (d / r.numel(), k))
    return dict(entries=total, changed=changed, differ_from_bf16=differ,
                worst_tensor=worst[1], worst_tensor_differ_share=worst[0])


def trajectory(dev, smoke, arch, cfg, tokens, steps: int, fp32: bool,
               lr_scale: float, first=None) -> dict:
    """Losses of the warm-up and ``steps`` more steps from the cell's
    weights; ``first(model)`` is called after the warm-up step."""
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        smoke.LM_SEED + 3), device=dev)
    if fp32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        named = {k: p.float() for k, p in model.named_parameters()}
        del model
        model = set_named_params(arch.module(cfg), named)
        del named
    out = {}
    if first is not None and not fp32:
        out["w0"] = host(model)
    step = make_train_step(arch.loss_fn(cfg, "train_4k"), dataclasses.replace(
        arch.opt, lr=arch.opt.lr * lr_scale))
    opt = init_adamw(model)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    mem0 = smoke.reset_peak(dev)
    losses, t0 = [], time.perf_counter()
    for i in range(steps + 1):
        _, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
        if i == 0 and first is not None:
            out.update(first(model))
    out.update(losses=losses, seconds=round(time.perf_counter() - t0, 3),
               **smoke.peak_memory(dev, mem0))
    del model, opt
    smoke.free(dev)
    return out


def witness(dev, smoke, arch_id: str, steps: int,
            reduced: bool = False) -> dict:
    arch = get_arch(arch_id)
    cfg, b, s = smoke.lm_plan(arch_id, reduced)["train_4k"]
    rng = np.random.default_rng(smoke.LM_SEED)           # as lm_arch draws
    zipf = smoke.ZipfIds(rng, cfg.vocab)
    tokens = torch.from_numpy(smoke.lm_tokens(rng, zipf, (b, s + 1))).to(dev)
    saved = {}
    out = dict(layers=cfg.n_layers, batch=b, seq=s, ln_vocab=math.log(
        cfg.vocab))
    for name, (fp32, scale) in RUNS.items():
        first = None
        if name == "bf16":
            def first(model):
                saved["w1"] = host(model)
                return {}
        elif name == "fp32":
            def first(model):
                return {"step1": moved(model, saved["w0"], saved["w1"])}
        try:
            rec = trajectory(dev, smoke, arch, cfg, tokens, steps, fp32,
                             scale, first)
        except torch.cuda.OutOfMemoryError as e:      # recorded, not fatal
            rec = {"out_of_memory": str(e).splitlines()[0]}
            smoke.free(dev)
        if "w0" in rec:
            saved["w0"] = rec.pop("w0")
        out[name] = rec
        print(json.dumps({arch_id: {name: rec}}), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arches", nargs="+", default=["qwen3-8b", "gemma3-27b"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--part", action="store_true",
                    help="run chip_smoke's lm part alone instead")
    ap.add_argument("--parity", action="store_true",
                    help="run the lm part's step-1 parity of each arch "
                         "instead")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = chip_smoke()
    dev = torch.device("cuda")
    print(smoke.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    if args.part:
        out = smoke.lm_phases(dev)
        out = {"seconds": out["seconds"]}
    elif args.parity:
        out = {a: smoke.lm_parity(dev, a, get_arch(a).config())
               for a in smoke.LM_ARCHES}
    else:
        out = {a: witness(dev, smoke, a, args.steps) for a in args.arches}
    out["total_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
