"""The three perf cells' variants, each counted per rank at 16 x 16 and
timed on one card (the twin of ``repro/launch/perf.py``).

Each entry of ``experiments/perf_torch/<cell>.json`` records a variant's
hypothesis and two measurements:

  * ``roofline``: one rank's step at the 16 x 16 production mesh, counted
    on ``meta`` tensors under :class:`~repro_torch.launch.op_cost.OpCounter`
    over a ``fake`` process group of 256 ranks (as the dry run counts a
    cell: :func:`repro_torch.launch.dryrun.rank_step`), with its H100
    terms (:mod:`repro_torch.launch.roofline`); ``count_s`` stands where
    the reference records ``compile_s``, and ``compute`` says whether the
    rank computes its block (``"sharded"``) or, through ``sharded_step``,
    the whole step (``"replicated"``).
  * ``timed``: the same variant on one card, after the fake group is
    gone, on a one-device mesh (``launch.mesh.make_host_mesh``): the
    median of ``TIMED_CALLS`` calls timed with CUDA events after one
    warm-up, the peak of ``torch.cuda.max_memory_allocated``, the shape
    it ran with every cut from the counted one in ``reduced``, and that
    shape counted on ``meta`` too: ``flop_share = t_compute / measured``
    (at most ``ROOFLINE_FLOP_SHARE_MAX``) and ``byte_share``.  The warm-up
    call's outputs are held to the baseline's.

Cells (the reference's):
  1. acorn ``serve_25m``: the baseline, the chunked scan, the scan over a
     bf16 corpus, ``filtered_topk`` (the CUDA kernel on the rank's block,
     then the step's global merge) and ``filtered_topk`` on a bf16 corpus
     (the entry the reference models, counted and timed here under the
     reference's name).  Timed at rank 0's block: 98,304 rows.
  2. smollm-360m ``train_4k``: the ``baseline`` and ``pure_dp`` layouts
     and ``pure_dp`` with bf16 logits.  On one card the layouts are one
     program, timed once; timed at (layers, batch) ``SMOLLM_TIMED``.
  3. dcn-v2 ``retrieval_cand``: ``retrieve`` and ``retrieve_opt``, timed
     at the full cell.

Any gate that fails (a ``flop_share`` above the limit, a variant's outputs
off its baseline's) raises, and the run exits non-zero.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf [--cell 1|2|3|all]
  PYTHONPATH=src python -m repro_torch.launch.perf --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.acorn import ACORN_SHAPES, REDUCED_ACORN_SHAPES
from repro_torch.configs.lm_common import (LM_SHAPES, REDUCED_SHAPES,
                                          model_flops)
from repro_torch.configs.recsys_common import (RECSYS_SHAPES,
                                               REDUCED_RECSYS_SHAPES)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import all_gather_cat, top_k
from repro_torch.kernels.filtered_topk import filtered_topk
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.roofline import (ROOFLINE_FLOP_SHARE_MAX, Roofline,
                                         analyze)
from repro_torch.train.optimizer import init_adamw

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "perf_torch")
RANKS = 256                  # the 16 x 16 production mesh
TIMED_CALLS = 5              # timed calls a variant, after one warm-up
SEED = 0
ACORN_SHAPE = "serve_25m"
ACORN_CHUNK = 8192           # the step's default scan block
REDUCED_CHUNK = 256          # the reference test's block at REDUCED
SMOLLM_TIMED = (32, 8)       # (layers, batch) of the card's train_4k step
# output gates: a variant against its baseline
TIE_REL = 1e-5               # near tie: float64 distances this close
DIST_ATOL = 1e-3             # dists where the ids agree
BF16_OVERLAP_MIN = 0.9       # bf16 corpus: top-k overlap with fp32's
DCN_ATOL = 1e-5              # retrieve_opt against retrieve
LOSS_RTOL = 2e-2             # bf16 logits' loss against fp32's

ACORN_VARIANTS = (
    ("baseline (materialized scores)",
     "full (B, n_local) f32 score matrix costs 3-4 HBM passes on top of "
     "the corpus read -> memory-bound", dict(optimized=False)),
    ("opt1: chunked running top-k",
     "scanning corpus chunks with a running top-k keeps scores in a "
     "chunk-sized working set; HBM traffic drops to ~corpus+masks "
     "(predicted Tm ~/4)", dict(optimized=True)),
    ("opt2: chunked + bf16 corpus",
     "corpus read dominates after opt1; bf16 halves it (predicted Tm ~/2 "
     "again; ranking precision validated in tests)",
     dict(optimized=True, bf16=True)),
    ("filtered_topk (CUDA)",
     "the kernel keeps each score tile on chip: HBM traffic = corpus + "
     "masks + per-tile top-k only (counted by kernels/cost.py's formula; "
     "launched on the card)", dict(kernel=True)),
    ("filtered_topk (modeled, bf16)",
     "the kernel's traffic with a bf16 corpus: corpus/2 + masks + per-tile "
     "top-k (counted by kernels/cost.py's formula at 2 bytes a corpus "
     "element; launched on the card)", dict(kernel=True, bf16=True)),
)
# the variant whose name is the reference's for an entry it only models
ACORN_NOTES = {
    "filtered_topk (modeled, bf16)":
        "the reference models this entry analytically; the port counts it "
        "and times the kernel on a bf16 corpus (the name is the "
        "reference's)"}

SMOLLM_VARIANTS = (
    ("baseline",
     "FSDP+TP layout: 15 heads don't divide the model axis, so attention "
     "runs replicated 16x per data shard — f32 score traffic dominates "
     "(Tm huge, useful-ratio ~0)", "baseline", True),
    ("pure_dp",
     "360M params fit replicated; batch over all 256 chips makes attention "
     "per-chip B=1 (16x less score traffic) at the cost of a full-size "
     "gradient all-reduce (predicted: Tm /16, Tx ~same order, "
     "useful-ratio ~x16)", "pure_dp", True),
    ("pure_dp + bf16 logits",
     "post-reshard Tm is dominated by the (256/256,4096,49152) f32 logits "
     "tensor and its softmax chain; bf16 logits halve it (predicted Tm "
     "~/1.6)", "pure_dp", False),
)
SMOLLM_NOTE = ("sharded_step gathers every argument whole and runs the "
               "whole step on every rank, so both layouts count the same "
               "Tc and Tm and differ only in Tx (ROADMAP queue 2b item 13)")

DCN_VARIANTS = (
    ("baseline (broadcast ids)",
     "broadcasting the user's 26 sparse ids to 1M rows makes XLA "
     "all-gather every row-sharded table (~1.3 GB/chip)", False),
    ("opt: hoist constant user features",
     "25 of 26 features are candidate-independent: look them up once at "
     "B=1 and broadcast 16-dim embeddings; only the candidate column's "
     "table is touched (predicted Tx /10+)", True),
)
DCN_NOTE = ("sharded_step gathers every table whole on every rank for "
            "either variant, so Tx is equal, not /10+ (ROADMAP queue 2b "
            "item 13)")


# ---------------------------------------------------------------------------
# measuring
# ---------------------------------------------------------------------------

def _meta_like(tree):
    """Empty ``meta`` tensors of ``tree``'s tensors' shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_meta_like(v) for v in tree)
    return tree


def run_timed(step, args, dev: torch.device) -> tuple:
    """(outputs of the warm-up call, its time and peak): ``step(*args)``
    once, then on a card ``TIMED_CALLS`` more calls, each between two CUDA
    events; ms is their median, ``peak_gb`` the peak of
    ``max_memory_allocated`` over all of them (inputs included).  Off the
    card nothing is timed (``None``)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = step(*args)
    timing = dict(calls=TIMED_CALLS, warmup=1, ms=None, ms_all=None,
                  peak_gb=None)
    if cuda:
        torch.cuda.synchronize(dev)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TIMED_CALLS)]
        for e0, e1 in ev:
            e0.record()
            step(*args)
            e1.record()
        torch.cuda.synchronize(dev)
        ms = [e0.elapsed_time(e1) for e0, e1 in ev]
        timing.update(ms=statistics.median(ms), ms_all=ms,
                      peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return out, timing


def shares(roof: Roofline, ms: Optional[float]) -> tuple:
    """(flop_share, byte_share) of a step counted as ``roof`` and timed at
    ``ms``: its counted FLOP and byte times over the measured one.  Raises
    ``AssertionError`` if ``flop_share`` exceeds
    ``ROOFLINE_FLOP_SHARE_MAX`` (a step cannot beat its FLOPs at the
    card's peaks: the counter or a peak is wrong).  ``(None, None)``
    without a time."""
    if ms is None:
        return None, None
    flop_share = roof.t_compute * 1e3 / ms
    if not flop_share <= ROOFLINE_FLOP_SHARE_MAX:
        raise AssertionError(
            f"measured {ms} ms beats the counted FLOP time "
            f"{roof.t_compute * 1e3:.4f} ms (flop_share {flop_share:.3f} > "
            f"{ROOFLINE_FLOP_SHARE_MAX})")
    return flop_share, roof.t_memory * 1e3 / ms


def timed_record(step, args, meta_args, dev: torch.device, shape: dict,
                 reduced: List[str],
                 model_flops_: Optional[float] = None) -> tuple:
    """(warm-up outputs, ``timed`` record): ``step`` timed on ``args`` by
    :func:`run_timed`, and counted on ``meta_args``, the same arguments on
    ``meta`` (the shares)."""
    out, timing = run_timed(step, args, dev)
    counter, count_s = dryrun.count_call(step, meta_args)
    roof = analyze(counter, model_flops=model_flops_)
    flop_share, byte_share = shares(roof, timing["ms"])
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return out, dict(
        device=name, shape=shape, reduced=reduced, **timing,
        counted=dict(flops=roof.total_flops, bytes=roof.bytes_accessed,
                     t_compute=roof.t_compute, t_memory=roof.t_memory,
                     kernels=counter.kernels, count_s=round(count_s, 2)),
        flop_share=flop_share, byte_share=byte_share)


def counted_entry(variant: str, hypothesis: str, arch, cfg, shape: str,
                  step, whole: tuple, in_specs=None, model_flops_=None,
                  note: Optional[str] = None) -> dict:
    """One rank's ``step`` on the whole arguments ``whole`` at the 16 x 16
    mesh of the existing (fake) group, counted as the dry run counts it."""
    mesh = make_production_mesh()
    step, args, compute = dryrun.rank_step(arch, cfg, shape, mesh, step,
                                           whole, in_specs)
    del whole
    counter, count_s = dryrun.count_call(step, args)
    roof = analyze(counter, model_flops=model_flops_)
    return dict(variant=variant, hypothesis=hypothesis,
                roofline=roof.to_dict(mesh.size), count_s=round(count_s, 2),
                compute=compute, kernels=counter.kernels, timed=None,
                note=note)


# ---------------------------------------------------------------------------
# output gates
# ---------------------------------------------------------------------------

def check_topk(ids, dists, want_ids, want_dists, q, x, what: str,
               exact: bool = False) -> dict:
    """Ids equal ``want_ids`` (``exact``) or equal except at near ties
    (the two rows' squared distances, in float64, within ``TIE_REL`` of
    the larger of them and |q|^2 + |x|^2, the scale of the expanded
    form's rounding); -1 padding identical; dists within ``DIST_ATOL``
    where the ids agree.  Returns {near_ties, max_abs_err}."""
    ids, want_ids = ids.cpu(), want_ids.cpu()
    dists, want_dists = dists.cpu().double(), want_dists.cpu().double()
    if not torch.equal(ids < 0, want_ids < 0):
        raise AssertionError(f"{what}: -1 padding differs")
    diff = (ids != want_ids).nonzero().tolist()
    if exact and diff:
        raise AssertionError(f"{what}: {len(diff)} ids differ")
    for qi, j in diff:
        a, b = int(ids[qi, j]), int(want_ids[qi, j])
        qv = q[qi].double().cpu()
        xa, xb = x[a].double().cpu(), x[b].double().cpu()
        da, db = float(((xa - qv) ** 2).sum()), float(((xb - qv) ** 2).sum())
        scale = max(da, db, float(qv @ qv) + max(float(xa @ xa),
                                                 float(xb @ xb)))
        if abs(da - db) > TIE_REL * scale:
            raise AssertionError(f"{what}: query {qi} slot {j}: ids {a} vs "
                                 f"{b} at {da} vs {db}, not a near tie")
    same = (ids == want_ids) & (ids >= 0)
    err = float((dists - want_dists).abs()[same].max()) if bool(
        same.any()) else 0.0
    if not err <= DIST_ATOL:
        raise AssertionError(f"{what}: dists differ by {err}")
    return dict(near_ties=len(diff), max_abs_err=err)


def topk_overlap(ids, want_ids) -> float:
    """Mean over queries of |ids ∩ want_ids| / k."""
    k = ids.shape[1]
    return sum(len(set(a) & set(b)) / k for a, b in
               zip(ids.tolist(), want_ids.tolist())) / ids.shape[0]


# ---------------------------------------------------------------------------
# cell 1: acorn serve_25m
# ---------------------------------------------------------------------------

def filtered_topk_step(mesh, k: int = 10):
    """``serve(x_l, queries, masks_l, base=0)`` -> (ids, dists), as the
    acorn step returns them, with ``filtered_topk`` (l2) scoring the
    rank's block in place of the matmul and ``top_k``, then the step's
    global merge: scores (minus the distances) and ids gathered over every
    mesh axis, the top k of them, -1 where the score is not finite."""
    axes = tuple(mesh.axis_names)

    def local(x_l, q, m_l, base):
        ids, d = filtered_topk(q, x_l, m_l, k, "l2")
        s = -d
        ids = torch.where(ids >= 0, ids + base, ids)
        for ax in axes:
            s = all_gather_cat(s, mesh, ax, dim=1)
            ids = all_gather_cat(ids, mesh, ax, dim=1)
        s2, pos = top_k(s, min(k, s.shape[1]))
        ids2 = torch.gather(ids, 1, pos)
        return (torch.where(torch.isfinite(s2), ids2,
                            torch.full_like(ids2, -1)), -s2)

    def serve(x_l, queries, masks_l, base: int = 0):
        b = queries.shape[0]
        outs = None
        if mesh.coordinate is not None:
            outs = local(x_l, queries, masks_l, base)
        return mesh.share(outs, [((b, k), torch.int32),
                                 ((b, k), torch.float32)], queries.device)

    serve.mesh_explicit = True
    return serve


def _acorn_step(mesh, reduced: bool, optimized=False, kernel=False,
                bf16=False):
    if kernel:
        return filtered_topk_step(mesh)
    return get_arch("acorn").step_fn(
        None, ACORN_SHAPE, reduced=reduced, mesh=mesh, optimized=optimized,
        chunk=REDUCED_CHUNK if reduced else ACORN_CHUNK)


def acorn_counted(reduced: bool = False) -> List[dict]:
    """The five variants' entries, counted at 16 x 16 (in a fake
    group)."""
    arch = get_arch("acorn")
    mesh = make_production_mesh()
    out = []
    for variant, hyp, kw in ACORN_VARIANTS:
        x, q, m = dryrun.meta_inputs(arch, None, ACORN_SHAPE, reduced)
        if kw.get("bf16"):
            x = torch.empty(x.shape, dtype=torch.bfloat16, device="meta")
        out.append(counted_entry(variant, hyp, arch, None, ACORN_SHAPE,
                                 _acorn_step(mesh, reduced, **kw),
                                 (x, q, m), note=ACORN_NOTES.get(variant)))
    return out


def acorn_inputs(n: int, d: int, b: int, dev: torch.device) -> tuple:
    """(x, queries, masks) drawn on ``dev`` from a generator seeded with
    ``SEED``: normal fp32 rows and queries, masks passing each row with
    probability 1/2, drawn as bool 16 queries at a time."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, d), generator=gen, device=dev)
    q = torch.randn((b, d), generator=gen, device=dev)
    masks = torch.empty((b, n), dtype=torch.bool, device=dev)
    for i in range(0, b, 16):
        rows = slice(i, min(i + 16, b))
        masks[rows] = torch.rand((rows.stop - i, n), generator=gen,
                                 device=dev) < 0.5
    return x, q, masks


def acorn_timed(device: DeviceLike = "cuda",
                reduced: bool = False) -> Dict[str, dict]:
    """{variant: timed record} of the five acorn variants on one device,
    at rank 0's block of the 16 x 16 mesh (``serve_25m``: 98,304 rows;
    REDUCED: the whole cell), each checked against the baseline: the
    chunked scan's ids identical and dists within ``DIST_ATOL``; a bf16
    corpus's ids (the scan's and ``filtered_topk``'s) overlapping the
    baseline's by ``BF16_OVERLAP_MIN``; ``filtered_topk``'s ids identical
    except at near ties."""
    dev = resolve_device(device)
    spec = (REDUCED_ACORN_SHAPES if reduced else ACORN_SHAPES)[ACORN_SHAPE]
    b, d, k = spec["batch"], spec["d"], spec["k"]
    n = spec["n"] if reduced else spec["n"] // RANKS
    x, q, masks = acorn_inputs(n, d, b, dev)
    mesh = make_host_mesh()
    arch = get_arch("acorn")
    cut = (["REDUCED shapes"] if reduced else []) + [
        "one device: the mesh's all-gathers of the (B, k) scores and ids "
        "are not run"]
    shape = dict(batch=b, n=n, d=d, k=k,
                 chunk=REDUCED_CHUNK if reduced else ACORN_CHUNK)
    outs, recs = {}, {}
    with torch.no_grad():
        for variant, _, kw in ACORN_VARIANTS:
            xv = x.to(torch.bfloat16) if kw.get("bf16") else x
            args = arch.place_inputs(ACORN_SHAPE, mesh, xv, q, masks)
            outs[variant], recs[variant] = timed_record(
                _acorn_step(mesh, reduced, **kw), args, _meta_like(args),
                dev,
                dict(shape, corpus_dtype=str(xv.dtype).split(".")[-1]), cut)
            del xv, args
    base_name = ACORN_VARIANTS[0][0]
    ib, db = outs[base_name]
    for variant, _, kw in ACORN_VARIANTS[1:]:
        ids, dists = outs[variant]
        what = f"acorn {variant} vs baseline"
        if kw.get("bf16"):
            ov = topk_overlap(ids, ib)
            if not ov >= BF16_OVERLAP_MIN:
                raise AssertionError(f"{what}: overlap {ov}")
            check = dict(overlap=ov)
        else:
            check = check_topk(ids, dists, ib, db, q, x, what,
                               exact=not kw.get("kernel"))
        recs[variant]["check"] = check
    return recs


def cell_acorn(entries: List[dict], device: DeviceLike,
               reduced: bool = False) -> List[dict]:
    """The counted ``entries`` with each variant's ``timed``."""
    timed = acorn_timed(device, reduced)
    for e in entries:
        e["timed"] = timed[e["variant"]]
    return entries


# ---------------------------------------------------------------------------
# cell 2: smollm-360m train_4k
# ---------------------------------------------------------------------------

def smollm_counted(reduced: bool = False) -> List[dict]:
    """The three variants' entries, counted at 16 x 16 (in a fake group);
    REDUCED: the REDUCED config at the cell's (256, 4096) tokens, the
    batch both layouts' specs split."""
    arch = get_arch("smollm-360m")
    cfg = arch.config(reduced=reduced)
    mf = model_flops(cfg, RANKS * 4096, train=True)
    mesh = make_production_mesh()
    out = []
    for variant, hyp, layout, f32 in SMOLLM_VARIANTS:
        c = dataclasses.replace(cfg, logits_f32=f32)
        whole = dryrun.meta_inputs(arch, c, "train_4k")
        out.append(counted_entry(
            variant, hyp, arch, c, "train_4k", arch.step_fn(c, "train_4k"),
            whole, arch.in_shardings(c, "train_4k", mesh, layout=layout),
            mf, SMOLLM_NOTE))
    return out


def smollm_timed(device: DeviceLike = "cuda", layers: Optional[int] = None,
                 batch: Optional[int] = None,
                 reduced: bool = False) -> Dict[bool, dict]:
    """{logits_f32: timed record} of smollm's ``train_4k`` step on one
    device at (``layers``, ``batch``) (default ``SMOLLM_TIMED``; REDUCED:
    its config and shape), each from the same seeded weights and batch:
    both warm-up losses finite, bf16 logits' within ``LOSS_RTOL`` of
    fp32's."""
    dev = resolve_device(device)
    arch = get_arch("smollm-360m")
    cfg = arch.config(reduced=reduced)
    spec = (REDUCED_SHAPES if reduced else LM_SHAPES)["train_4k"]
    full_b, s = spec["batch"], spec["seq"]
    if reduced:
        layers, b = cfg.n_layers, full_b
    else:
        layers = layers or SMOLLM_TIMED[0]
        b = batch or SMOLLM_TIMED[1]
    cut = ["REDUCED config and shape"] if reduced else []
    if layers != cfg.n_layers:
        cut.append(f"layers {layers} of {cfg.n_layers}")
    if b != full_b:
        cut.append(f"batch {b} of {full_b}")
    cut.append("one device: the layouts' gathers are not run")
    cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen, device=dev,
                        dtype=torch.int32)
    data = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    mf = model_flops(cfg, b * s, train=True)
    losses, recs = {}, {}
    for f32 in (True, False):
        c = dataclasses.replace(cfg, logits_f32=f32)
        model = arch.init(c, torch.Generator(device=dev).manual_seed(SEED + 1),
                          device=dev)
        meta = arch.module(c)
        out, recs[f32] = timed_record(
            arch.step_fn(c, "train_4k"), (model, init_adamw(model), data),
            (meta, init_adamw(meta), _meta_like(data)), dev,
            dict(layers=layers, batch=b, seq=s), cut, mf)
        losses[f32] = float(out[2])
        recs[f32]["loss_warmup"] = losses[f32]
        del model, out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rel = abs(losses[False] - losses[True]) / abs(losses[True])
    if not all(map(math.isfinite, losses.values())) or not rel <= LOSS_RTOL:
        raise AssertionError(f"smollm train_4k losses {losses}: bf16 "
                             f"logits off by {rel} of fp32's")
    recs[False]["check"] = dict(loss_rel_err=rel)
    return recs


def cell_smollm(entries: List[dict], device: DeviceLike,
                reduced: bool = False) -> List[dict]:
    """The counted ``entries`` with ``timed``: both layouts the fp32
    logits' step (one program on one device), then the bf16 logits'."""
    timed = smollm_timed(device, reduced=reduced)
    for e, (_, _, _, f32) in zip(entries, SMOLLM_VARIANTS):
        e["timed"] = dict(timed[f32], same_program_on_one_rank=f32)
    return entries


# ---------------------------------------------------------------------------
# cell 3: dcn-v2 retrieval_cand
# ---------------------------------------------------------------------------

def dcn_counted(reduced: bool = False) -> List[dict]:
    arch = get_arch("dcn-v2")
    cfg = arch.config(reduced=reduced)
    out = []
    for variant, hyp, opt in DCN_VARIANTS:
        whole = dryrun.meta_inputs(arch, cfg, "retrieval_cand", reduced)
        out.append(counted_entry(
            variant, hyp, arch, cfg, "retrieval_cand",
            arch.step_fn(cfg, "retrieval_cand", optimized=opt), whole,
            note=DCN_NOTE))
    return out


def dcn_timed(device: DeviceLike = "cuda",
              reduced: bool = False) -> Dict[bool, dict]:
    """{optimized: timed record} of DCN-v2's ``retrieval_cand`` on one
    device at the full cell (REDUCED: its config and shape): one seeded
    user against every candidate drawn uniformly from the first feature's
    vocabulary; ``retrieve_opt`` within ``DCN_ATOL`` of ``retrieve``."""
    dev = resolve_device(device)
    arch = get_arch("dcn-v2")
    cfg = arch.config(reduced=reduced)
    n = (REDUCED_RECSYS_SHAPES if reduced
         else RECSYS_SHAPES)["retrieval_cand"]["n_candidates"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = arch.init(cfg, gen, device=dev)
    user = {"dense": torch.randn((1, cfg.n_dense), generator=gen, device=dev),
            "sparse": torch.stack([
                torch.randint(0, v, (1,), generator=gen, device=dev)
                for v in cfg.vocab_sizes], dim=1).to(torch.int32)}
    cand = torch.randint(0, cfg.vocab_sizes[0], (n,), generator=gen,
                         device=dev, dtype=torch.int32)
    cut = (["REDUCED config and shape"] if reduced else []) + [
        "one device: the tables are not gathered"]
    outs, recs = {}, {}
    with torch.no_grad():
        for _, _, opt in DCN_VARIANTS:
            outs[opt], recs[opt] = timed_record(
                arch.step_fn(cfg, "retrieval_cand", optimized=opt),
                (model, user, cand),
                (arch.module(cfg), _meta_like(user), _meta_like(cand)), dev,
                dict(n_candidates=n), cut)
    err = float((outs[True] - outs[False]).abs().max())
    if not err <= DCN_ATOL:
        raise AssertionError(f"dcn-v2 retrieve_opt off retrieve by {err}")
    recs[True]["check"] = dict(max_abs_err=err)
    return recs


def cell_dcn(entries: List[dict], device: DeviceLike,
             reduced: bool = False) -> List[dict]:
    """The counted ``entries`` with ``timed``."""
    timed = dcn_timed(device, reduced)
    for e, (_, _, opt) in zip(entries, DCN_VARIANTS):
        e["timed"] = timed[opt]
    return entries


# ---------------------------------------------------------------------------

# --cell: (record name, counted at 16 x 16, then timed)
CELLS = {"1": ("acorn__serve_25m", acorn_counted, cell_acorn),
         "2": ("smollm-360m__train_4k", smollm_counted, cell_smollm),
         "3": ("dcn-v2__retrieval_cand", dcn_counted, cell_dcn)}


def record(cell: str, entries: List[dict], out_dir: str) -> str:
    """Write ``entries`` to ``<out_dir>/<cell>.json`` and print a line per
    variant: the counted terms, then ms, peak GB and ``flop_share``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell + ".json")
    with open(path, "w") as f:
        json.dump(entries, f, indent=1)
    print(f"\n--- {cell} ---")
    for e in entries:
        r, t = e["roofline"], e["timed"] or {}
        print(f"{e['variant']:34s} Tc={r['t_compute']:.2e} "
              f"Tm={r['t_memory']:.2e} Tx={r['t_collective']:.2e} "
              f"-> {r['bottleneck']} | ms={t.get('ms')} "
              f"peak_gb={t.get('peak_gb')} "
              f"flop_share={t.get('flop_share')}", flush=True)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="all", choices=["1", "2", "3", "all"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="count and time the REDUCED configs and shapes")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    keys = list(CELLS) if args.cell == "all" else [args.cell]
    counted = {}
    t0 = time.perf_counter()
    with dryrun.fake_group(RANKS):     # one group: meshes are cached by it
        for key in keys:
            counted[key] = CELLS[key][1](args.reduced)
    print(f"[count] {time.perf_counter() - t0:.1f} s", flush=True)
    for key in keys:
        cell, _, timed = CELLS[key]
        t0 = time.perf_counter()
        record(cell, timed(counted[key], dev, args.reduced), args.out)
        print(f"[{cell}] timed {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
