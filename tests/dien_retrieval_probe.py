"""DIEN's FULL ``retrieval_cand`` on one card: this tree's candidate loop
against an earlier one, in turns, on the same model and inputs.

The earlier loop is ``dien_score_candidates`` of the ``models/recsys.py``
under ``--baseline DIR`` (an earlier ``src/repro_torch``, e.g. unpacked
from ``git archive <commit> src/repro_torch`` into a directory that
``.gitignore`` lists), loaded beside this tree's module.  The model is
``chip_smoke.py``'s recsys part's (FULL, seeded generator on the card),
the user and its 2^20 candidates its DIEN retrieval traffic: a user with
all 100 history steps valid, then the same user with only its first
``--valid`` steps valid.  For each: one warm-up of each loop, then one
timed call each in the order earlier, this, this, earlier (synchronised,
host clock), and whether the two loops' scores are bit-equal.  Needs a
CUDA card:

    PYTHONPATH=src:tests python tests/dien_retrieval_probe.py \\
        --baseline experiments/parent/src/repro_torch [--valid 40]

The last line of the output is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier src/repro_torch directory")
    ap.add_argument("--valid", type=int, default=40,
                    help="valid history steps of the second user")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dien_retrieval_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys
    # its relative imports resolve to this tree's models package
    earlier = load("repro_torch.models.earlier_recsys",
                   os.path.join(args.baseline, "models", "recsys.py"))
    dev = torch.device("cuda")
    arch = get_arch("dien")
    cfg = arch.config()
    model = arch.init(cfg, torch.Generator(device=dev).manual_seed(
        smoke.RECSYS_SEED), device=dev)
    host = smoke.recsys_traffic("dien", cfg)(1, "retrieval", 1 << 20)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    user = {k: v for k, v in batch.items() if not k.startswith("cand_")}
    items, cates = batch["cand_items"], batch["cand_cates"]
    out = dict(device=smoke.nvidia_smi(), candidates=int(items.shape[0]))
    for label, valid in (("full", None), ("partial", args.valid)):
        u = dict(user)
        if valid is not None:
            u["mask"] = u["mask"].clone()
            u["mask"][:, valid:] = 0
        fns = {"earlier": lambda: earlier.dien_score_candidates(
                   cfg, model, u, items, cates),
               "this": lambda: recsys.dien_score_candidates(
                   cfg, model, u, items, cates)}
        ms = {"earlier": [], "this": []}
        with torch.no_grad():
            scores = {name: fn() for name, fn in fns.items()}
            torch.cuda.synchronize()
            for name in ("earlier", "this", "this", "earlier"):
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
                ms[name].append(round((time.perf_counter() - t0) * 1e3, 1))
        rec = dict(valid_steps=int((u["mask"][0] > 0).sum()),
                   earlier_ms=ms["earlier"], this_ms=ms["this"],
                   bit_equal=bool(torch.equal(scores["earlier"],
                                              scores["this"])))
        print(f"[dien] history={label} " + " ".join(
            f"{k}={v}" for k, v in rec.items()), flush=True)
        out[label] = rec
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
