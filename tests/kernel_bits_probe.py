"""The fp32 paths of ``filtered_topk`` (k <= 256) and ``embedding_bag``
on one card, bit for bit against an earlier build of their sources.

``--baseline DIR`` holds an earlier ``filtered_topk.cu`` and
``embedding_bag.cu`` (an earlier ``src/repro_torch/csrc``, e.g. unpacked
from ``git archive <commit> src/repro_torch/csrc`` into a directory that
``.gitignore`` lists) with the fp32-only C entry points; they are built
with the loader's flags into a library of their own.  Every
``chip_smoke.TOPK_EDGE_CASES`` case with n <= 6,000,000 (both metrics)
and every ``chip_smoke.BAG_EDGE_CASES`` case (sum and mean) runs through
both builds; ids and the bits of every dist and output must be equal.
Needs a CUDA card and nvcc:

    PYTHONPATH=src:tests python tests/kernel_bits_probe.py \\
        --baseline experiments/parent/src/repro_torch/csrc

The last line of the output is one JSON object with the counts.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def earlier_bag(src_dir: str):
    """The earlier ``embedding_bag.cu`` (fp32 tables) as a callable."""
    import torch
    from repro_torch.kernels import loader
    out = loader.BUILD_DIR / "earlier_bag"
    out.mkdir(parents=True, exist_ok=True)
    obj, lib_path = str(out / "embedding_bag.o"), str(out / "libbag.so")
    loader._run_all([[loader._nvcc(), *loader.NVCC_FLAGS, "-c",
                      os.path.join(src_dir, "embedding_bag.cu"), "-o",
                      obj]])
    loader._run_all([[loader._nvcc(), "-shared", obj, "-o", lib_path]])
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_embedding_bag.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.repro_embedding_bag.restype = i

    def bag(ids, table, mode):
        b, l = ids.shape
        v, d = table.shape
        res = torch.empty((b, d), device=table.device)
        loader.check(lib.repro_embedding_bag(
            ids.data_ptr(), table.data_ptr(), res.data_ptr(), b, l, v, d,
            int(mode == "mean"), torch.cuda.current_stream().cuda_stream),
            "earlier embedding_bag")
        return res
    return bag


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


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
    from repro_torch.kernels.filtered_topk import filtered_topk_cuda
    dev = torch.device("cuda")
    topk = smoke.baseline_kernels(args.baseline)[2]
    bag = earlier_bag(args.baseline)
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
                    and same_bits(new[1], old[1])):
                raise AssertionError(f"filtered_topk {case} {metric}")
            counts["filtered_topk"] += 1
    for ci, case in enumerate(smoke.BAG_EDGE_CASES):
        ids, table, _ = (torch.from_numpy(a).to(dev)
                         for a in smoke.bag_inputs(**case, seed=ci))
        for mode in ("sum", "mean"):
            new, old = embedding_bag_cuda(ids, table, mode), bag(ids, table,
                                                                 mode)
            torch.cuda.synchronize()
            if not same_bits(new, old):
                raise AssertionError(f"embedding_bag {case} {mode}")
            counts["embedding_bag"] += 1
    print(json.dumps(dict(device=smoke.nvidia_smi(), bit_identical=counts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
