"""DIEN's FULL ``train_batch`` step on one card with the two gathers
``default_lookup`` could use: ``F.embedding`` (the port's) and plain
``table[ids]`` indexing.

Both read the same rows; their CUDA backwards differ.  ``table[ids]``'s
(``index_put_`` with accumulation) sorts the ids and walks a row's repeats
one by one, and DIEN's histories repeat the popular items of a Zipf(1.1)
law many thousand times over a batch of 65,536.  ``F.embedding``'s
backward sums a row's repeats in parallel pieces.

The model is ``chip_smoke.py``'s recsys part's (FULL, seeded generator on
the card), the batch its DIEN traffic (B = 65,536).  For each gather: one
warm-up and ``--steps`` timed steps of ``get_arch("dien").step_fn(cfg,
"train_batch")`` (forward, backward and ``adamw_update``), then one
forward and backward under ``torch.profiler``, whose kernels are listed by
device time.  Needs a CUDA card:

    PYTHONPATH=src:tests python tests/dien_lookup_probe.py [--steps 5]

The last line of the output is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.recsys_common import RECSYS_SHAPES
from repro_torch.models import recsys
from repro_torch.train import init_adamw, value_and_grad


def index_lookup(table, ids):
    """``default_lookup`` through ``table[ids]`` (the same rows)."""
    safe = ids.clamp(0, table.shape[0] - 1).long()
    return torch.where((ids >= 0)[..., None], table[safe],
                       table.new_zeros(()))


def chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dien_lookup_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile
    cs = chip_smoke()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    arch = get_arch("dien")
    cfg = arch.config()
    b = RECSYS_SHAPES["train_batch"]["batch"]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             cs.recsys_traffic("dien", cfg)(b, "train").items()}
    step = arch.step_fn(cfg, "train_batch")
    loss_fn = arch.loss_fn(cfg, "train_batch")
    out = dict(device=smi, batch=b)
    real = recsys.default_lookup
    for name, lookup in (("F.embedding", real), ("table[ids]", index_lookup)):
        recsys.default_lookup = lookup
        model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
            cs.RECSYS_SEED), device=dev)
        opt = init_adamw(model)
        step(model, opt, batch)                       # warm-up
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step(model, opt, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            value_and_grad(loss_fn, model, batch)
            torch.cuda.synchronize()
        kernels = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages() if e.self_device_time_total > 0),
            key=lambda t: -t[1])
        rec = dict(step_p50_ms=float(np.median(ms)), step_ms=ms,
                   traced_device_ms=sum(k[1] for k in kernels),
                   top_kernels=[dict(name=k[0][:90], ms=k[1], calls=k[2])
                                for k in kernels[:args.top]])
        print(f"[lookup] {name} " + json.dumps(rec), flush=True)
        out[name] = rec
        del model, opt
        torch.cuda.empty_cache()
    recsys.default_lookup = real
    print(json.dumps(out))


if __name__ == "__main__":
    main()
