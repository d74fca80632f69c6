"""Render the dry run's tables from its JSON records (the twin of
``repro/launch/report.py``).

The records are counts of one rank's step (:mod:`repro_torch.launch.dryrun`),
turned into H100 roofline terms: they are not times measured on a card.
``Tc`` is split by dtype class (bf16 / fp16 at the tensor-core peak, fp32
and the rest at the fp32 peak), and ``compute`` says whether a rank's
compute is the whole step (``replicated``, ``sharded_step``) or its own
share (``sharded``, a mesh-explicit step: acorn serve, two-tower
``retrieval_cand``).

Usage: PYTHONPATH=src python -m repro_torch.launch.report
           [--dir experiments/dryrun] [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt(x, digits=2):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return f"{x:.{digits}e}"


def load(dirpath: str):
    recs = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _split(rf) -> str:
    """``Tc`` by dtype class: 'bf16 a / fp32 b / other c'."""
    by = rf.get("t_compute_by_dtype", {})
    return " / ".join(f"{k} {fmt(by.get(k))}" for k in ("bf16", "fp32",
                                                        "other"))


def roofline_table(recs, mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | Tc (s) | Tc by dtype (s) | Tm (s) | Tx (s) | "
        "bottleneck | compute | MODEL_FLOPS | useful ratio | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                         f"| - | - | - | SKIP: {r['reason'][:60]} |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                         f"| - | - | - | FAILED |")
            continue
        rf = r["roofline"]
        ratio = rf.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt(rf['t_compute'])} | "
            f"{_split(rf)} | {fmt(rf['t_memory'])} | "
            f"{fmt(rf['t_collective'])} | **{rf['bottleneck']}** | "
            f"{r.get('compute', '-')} | {fmt(rf.get('model_flops'))} | "
            f"{'-' if ratio is None else f'{ratio:.2e}'} | |")
    return "\n".join(lines)


def dryrun_summary(recs) -> str:
    ok = sum(1 for r in recs if r.get("status") == "ok")
    sk = sum(1 for r in recs if r.get("status") == "skipped")
    fail = sum(1 for r in recs if r.get("status") == "failed")
    lines = [f"cells: {ok} counted OK, {sk} skipped (documented), "
             f"{fail} failed", ""]
    for mesh in ["16x16", "2x16x16"]:
        sub = [r for r in recs if r.get("mesh") == mesh
               and r.get("status") == "ok"]
        if not sub:
            continue
        coll = [r for r in sub
                if r["roofline"]["bottleneck"] == "collective"]
        rep = [r for r in sub if r.get("compute") == "replicated"]
        lines.append(f"mesh {mesh}: {len(sub)} cells | "
                     f"{len(coll)} collective-bound | "
                     f"{len(rep)} with replicated compute")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(dryrun_summary(recs))
    print()
    print(roofline_table(recs, args.mesh))


if __name__ == "__main__":
    main()
