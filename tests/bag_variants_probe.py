"""Time ``embedding_bag``'s CUDA kernel on one card against an earlier
``embedding_bag.cu`` and against a persistent variant of its design, in one
process, over a table of the two-tower FULL user table's shape.  Needs a
CUDA card and nvcc:

    PYTHONPATH=src:tests python tests/bag_variants_probe.py \\
        --baseline experiments/base/src/repro_torch/csrc

``--baseline DIR`` holds an earlier ``src/repro_torch/csrc`` with the same
C entry points (``chip_smoke.baseline_kernels``).  Four parts, each record
printed as a JSON line:

1. ``launcher``: at (512, 4), sum, in each table dtype, ``ROUNDS`` rounds
   of three callers in turns, the first of a round rotating: the port's
   launcher (``embedding_bag_cuda``), the same kernel through a thin ctypes
   call (``thin``, as ``baseline_kernels`` calls the earlier kernel) and the
   earlier kernel (``baseline``).  Every other round starts after the card
   has sat idle ``IDLE_S``.  Each run is ``chip_smoke.time_ms``'s loop (a
   256 MiB overwrite before each call) that also keeps each call's device
   time, each iteration's host time and the garbage collector's passes.
   A run whose mean is over ``SLOW`` times its caller's median is slow.
2. ``turns``: ``chip_smoke.measure_embedding_bag`` with the earlier kernel
   (bits, times in turns, the plain version, one ``F.embedding_bag`` call,
   the bound), ``TURNS`` times at each of ``chip_smoke.BAG_SHAPES``, mode
   and dtype.
3. ``clean``: the kernel and the earlier one in turns after an overwrite
   followed by a read of the same buffer: the L2 then holds clean lines, so
   a call writes back nothing of the overwrite.
4. ``tma``: ``tests/bag_tma_variant.cu`` (a ring of rows in shared memory
   filled by ``cp.async.bulk``) at 2, 4 and 8 blocks an SM, its bits
   against the kernel's, in turns with the kernel.

The last line of the output is one JSON object with every record.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USER_TABLE = (4_194_304, 256)   # two_tower_retrieval.FULL's user table
ROUNDS = 96                     # launcher rounds per dtype
IDLE_S = 0.2                    # the card's idle time before every other round
SLOW = 1.5                      # a run this many times its caller's median
TURNS = 3                       # measure_embedding_bag calls per input
TMA_RING_BYTES = {2: 96 << 10, 4: 48 << 10, 8: 24 << 10}  # blocks an SM


def build(name: str, src: str, out_dir) -> ctypes.CDLL:
    from repro_torch.kernels import loader
    obj, so = str(out_dir / f"{name}.o"), str(out_dir / f"lib{name}.so")
    loader._run_all([[loader._nvcc(), *loader.NVCC_FLAGS, "-c", src, "-o",
                      obj]])
    loader._run_all([[loader._nvcc(), "-shared", obj, "-o", so]])
    return ctypes.CDLL(so)


def thin_kernel():
    """The port's kernel through one ctypes call, with nothing of the
    launcher's checks or device guard: ``baseline_kernels``'s form."""
    import torch
    from repro_torch.kernels import loader
    from repro_torch.kernels.embedding_bag.kernel import launch_shape
    fn = loader.library().repro_embedding_bag_shaped

    def bag(ids, table, mode):
        (b, l), (v, d) = ids.shape, table.shape
        out = torch.empty((b, d), dtype=table.dtype, device=table.device)
        loader.check(fn(ids.data_ptr(), table.data_ptr(), out.data_ptr(), b,
                        l, v, d, int(mode == "mean"),
                        loader.float_code(table),
                        *launch_shape(b, d, table.dtype),
                        torch.cuda.current_stream().cuda_stream), "thin")
        return out
    return bag


def tma_variant(lib, per_sm: int):
    import torch
    from repro_torch.kernels import loader
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.repro_embedding_bag_tma
    fn.argtypes, fn.restype = [p] * 3 + [i] * 8 + [p], i
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bag(ids, table, mode):
        (b, l), (v, d) = ids.shape, table.shape
        stages = TMA_RING_BYTES[per_sm] // (d * table.element_size())
        out = torch.empty((b, d), dtype=table.dtype, device=table.device)
        loader.check(fn(ids.data_ptr(), table.data_ptr(), out.data_ptr(), b,
                        l, v, d, int(mode == "mean"),
                        loader.float_code(table), sms * per_sm, stages,
                        torch.cuda.current_stream().cuda_stream), "tma")
        return out
    return bag


class CleanFlush:
    """``zero_()`` overwrites the buffer, then reads it back: the L2 ends
    holding clean lines of it."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.zero_()
        self.buf.max()


def timed_loop(fn, flush, iters: int, warmup: int = 3) -> dict:
    """``chip_smoke.time_ms``'s loop, keeping each call's device ms, each
    iteration's host µs (from before the overwrite to after the end event)
    and the iterations in which the garbage collector ran."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    host, passes = [], []

    def seen(phase, info):
        if phase == "start":
            passes.append((len(host), info["generation"]))
    gc.callbacks.append(seen)
    try:
        for t0, t1 in ev:
            h = time.perf_counter()
            flush.zero_()
            t0.record()
            fn()
            t1.record()
            host.append((time.perf_counter() - h) * 1e6)
    finally:
        gc.callbacks.remove(seen)
    torch.cuda.synchronize()
    ms = [t0.elapsed_time(t1) for t0, t1 in ev]
    return dict(mean=sum(ms) / iters, ms=ms, host_us=host, gc=passes)


def overwrite_ms(flush, n: int = 20) -> float:
    """Device ms of one overwrite: the card's lead over the host in each
    iteration of a timed loop."""
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    flush.zero_()
    t0.record()
    for _ in range(n):
        flush.zero_()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def launcher_study(smoke, callers, ids, table, flush) -> dict:
    """``ROUNDS`` rounds of ``callers`` in turns (see the module's doc);
    per caller its runs' means, median, and each slow run's shape: where
    its excess lies, its host times and collector passes."""
    import torch
    names = list(callers)
    runs = {name: [] for name in names}
    for r in range(ROUNDS):
        idle = r % 2 == 1
        if idle:
            torch.cuda.synchronize()
            time.sleep(IDLE_S)
        order = names[r % len(names):] + names[:r % len(names)]
        for pos, name in enumerate(order):
            run = timed_loop(lambda: callers[name](ids, table, "sum"), flush,
                             smoke.ITERS)
            run.update(round=r, position=pos, after_idle=idle and pos == 0)
            runs[name].append(run)
    out = {}
    for name, rs in runs.items():
        med = statistics.median(r["mean"] for r in rs)
        call = statistics.median(m for r in rs for m in r["ms"])
        slow = []
        for r in rs:
            if r["mean"] <= SLOW * med:
                continue
            excess = [max(m - call, 0.0) for m in r["ms"]]
            top = max(range(len(excess)), key=excess.__getitem__)
            slow.append(dict(
                mean=r["mean"], round=r["round"], position=r["position"],
                after_idle=r["after_idle"],
                top_iteration=top, top_ms=r["ms"][top],
                top_share=excess[top] / max(sum(excess), 1e-12),
                iterations_over_2x=sum(m > 2 * call for m in r["ms"]),
                host_us_at_top=r["host_us"][max(top - 2, 0):top + 1],
                host_us_median=statistics.median(r["host_us"]),
                gc=r["gc"]))
        host = [h for r in rs for h in r["host_us"]]
        quiet = [max(r["host_us"]) for r in rs if r["mean"] <= SLOW * med]
        out[name] = dict(
            runs=len(rs), median_ms=med, median_call_ms=call,
            means=[r["mean"] for r in rs], slow=slow,
            slow_first=sum(s["position"] == 0 for s in slow),
            slow_after_idle=sum(s["after_idle"] for s in slow),
            host_us_median=statistics.median(host),
            host_us_max_in_quiet_runs=max(quiet) if quiet else None,
            gc_passes=sum(len(r["gc"]) for r in rs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier src/repro_torch/csrc directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bag_variants_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import loader
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import MODES
    dev = torch.device("cuda")
    loader.library()
    base = smoke.baseline_kernels(args.baseline)
    out_dir = loader.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    tma_lib = build("bag_tma", os.path.join(ROOT, "tests",
                                            "bag_tma_variant.cu"), out_dir)
    tmas = {per_sm: tma_variant(tma_lib, per_sm) for per_sm in TMA_RING_BYTES}
    callers = dict(launcher=embedding_bag_cuda, thin=thin_kernel(),
                   baseline=base[4])

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
    clean = CleanFlush(flush)
    # warm the clocks before the first timed call
    smoke.time_ms(lambda: embedding_bag_cuda(inputs[-1], table), 200, flush)
    records = dict(device=smoke.nvidia_smi(), overwrite_ms=overwrite_ms(flush),
                   launcher=[], turns=[], clean=[], tma=[])
    print(json.dumps(dict(overwrite_ms=records["overwrite_ms"])), flush=True)

    def emit(part, rec):
        records[part].append(rec)
        print(json.dumps(dict(part=part, **rec)), flush=True)

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        tab = table if dt == torch.float32 else table.to(dt)
        name = str(dt).split(".")[-1]
        study = launcher_study(smoke, callers, inputs[0], tab, flush)
        emit("launcher", dict(dtype=name, shape=tuple(inputs[0].shape),
                              callers=study))
        for ids in inputs:
            for mode in MODES:
                what = dict(dtype=name, shape=tuple(ids.shape), mode=mode)
                for _ in range(TURNS):
                    emit("turns", dict(what, **smoke.measure_embedding_bag(
                        ids, tab, mode, flush, base)))
                emit("clean", dict(what, **smoke.time_in_turns(
                    lambda: embedding_bag_cuda(ids, tab, mode),
                    lambda: base[4](ids, tab, mode), clean)))
                want = embedding_bag_cuda(ids, tab, mode)
                for per_sm, fn in tmas.items():
                    emit("tma", dict(
                        what, blocks_per_sm=per_sm,
                        bit_identical=smoke.same_bits(fn(ids, tab, mode),
                                                      want),
                        **smoke.time_in_turns(
                            lambda: fn(ids, tab, mode),
                            lambda: embedding_bag_cuda(ids, tab, mode),
                            flush)))
                del want
        del tab
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
