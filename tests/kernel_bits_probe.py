"""``filtered_topk`` (fp32, k <= 256) and ``embedding_bag`` (fp32, bf16
and fp16 tables) on one card, bit for bit against an earlier build of their
sources.

``--baseline DIR`` holds an earlier ``src/repro_torch/csrc`` (e.g.
unpacked from ``git archive <commit> src/repro_torch/csrc`` into a
directory that ``.gitignore`` lists) with the same C entry points
(``repro_embedding_bag`` taking the table's type code); it is built with
the loader's flags into a library of its own
(``chip_smoke.baseline_kernels``).  Every ``chip_smoke.TOPK_EDGE_CASES``
case with n <= 6,000,000 (both metrics), and every
``chip_smoke.BAG_EDGE_CASES`` case and both ``chip_smoke.BAG_SHAPES`` over a
table of the two-tower FULL user table's shape (sum and mean, in each of
the three table dtypes) runs through both builds; ids and the bits of every
dist and output must be equal.  The ``BAG_SHAPES`` calls are also timed in
turns with the earlier kernel (``chip_smoke.measure_embedding_bag``: ms,
baseline_ms, bound, one ``F.embedding_bag`` call).  Needs a CUDA card and
nvcc:

    PYTHONPATH=src:tests python tests/kernel_bits_probe.py \\
        --baseline experiments/parent/src/repro_torch/csrc

The last line of the output is one JSON object with the counts and times.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USER_TABLE = (4_194_304, 256)   # two_tower_retrieval.FULL's user table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier src/repro_torch/csrc directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_bits_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import MODES
    from repro_torch.kernels.filtered_topk import filtered_topk_cuda
    dev = torch.device("cuda")
    base = smoke.baseline_kernels(args.baseline)
    topk, bag = base[2], base[4]
    counts = dict(filtered_topk=0, embedding_bag=0)
    for ci, case in enumerate(smoke.TOPK_EDGE_CASES):
        if case["n"] > 6_000_000:
            continue
        q, x, mask, k = smoke.topk_case(case, ci, dev)
        for metric in ("l2", "ip"):
            new, old = (filtered_topk_cuda(q, x, mask, k, metric),
                        topk(q, x, mask, k, metric))
            torch.cuda.synchronize()
            if not (torch.equal(new[0], old[0])
                    and smoke.same_bits(new[1], old[1])):
                raise AssertionError(f"filtered_topk {case} {metric}")
            counts["filtered_topk"] += 1
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    for ci, case in enumerate(smoke.BAG_EDGE_CASES):
        ids, table, _ = (torch.from_numpy(a).to(dev)
                         for a in smoke.bag_inputs(**case, seed=ci))
        for dt in dtypes:
            tab = table.to(dt)
            for mode in MODES:
                if not smoke.same_bits(embedding_bag_cuda(ids, tab, mode),
                                       bag(ids, tab, mode)):
                    raise AssertionError(f"embedding_bag {case} {mode} {dt}")
                counts["embedding_bag"] += 1
    # the bag phase's shapes and ids over a table of the user table's shape
    v, d = USER_TABLE
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((v, d), generator=gen, device=dev)
    rng = np.random.default_rng(5)
    inputs = []
    for b, l in smoke.BAG_SHAPES:
        ids = rng.integers(0, v, size=(b, l))
        ids[rng.random((b, l)) < smoke.BAG_PAD] = -1
        inputs.append(torch.as_tensor(ids.astype(np.int32), device=dev))
    flush = torch.empty(smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    timed = []
    for dt in dtypes:
        tab = table if dt == torch.float32 else table.to(dt)
        for ids in inputs:
            for mode in MODES:
                rec = smoke.measure_embedding_bag(ids, tab, mode, flush, base)
                if not rec["bit_identical_to_baseline"]:
                    raise AssertionError(f"embedding_bag {rec['shape']}")
                counts["embedding_bag"] += 1
                timed.append({key: rec[key] for key in (
                    "shape", "ms", "baseline_ms", "speedup", "bound_ms",
                    "library_ms")})
        del tab
    print(json.dumps(dict(device=smoke.nvidia_smi(), bit_identical=counts,
                          embedding_bag_timed=timed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
