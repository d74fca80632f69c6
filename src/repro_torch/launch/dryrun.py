"""Multi-pod dry run (the twin of ``repro/launch/dryrun.py``).

For every (architecture x input shape x production mesh) cell: build the
arch's step at full width on ``meta`` tensors (nothing is allocated), cut
rank 0's blocks of its arguments by the arch's ``in_shardings``, run the
step once under :class:`repro_torch.launch.op_cost.OpCounter`, and write
what one rank computes, moves and holds, with its H100 roofline terms
(:mod:`repro_torch.launch.roofline`), to
``experiments/dryrun/<arch>__<shape>__<mesh>.json``.
:mod:`repro_torch.launch.report` renders the records.

The reference forces 512 host devices and lowers one SPMD program.  The
port is multi-controller: a mesh device is a rank of the default process
group.  :func:`main` therefore joins a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``) of exactly 256 ranks for
the 16 x 16 mesh, then of 512 for 2 x 16 x 16, as rank 0, and destroys each
afterwards; every collective of rank 0's step is dispatched, counted and
returns at once.  :func:`run_cell` uses the group that exists.

How a rank's step runs: as in the reference, an arch whose ``step_fn``
takes ``mesh`` gets the mesh.
  * A step that comes back mesh-explicit (``step.mesh_explicit``: acorn's
    serve cells, two-tower's ``retrieval_cand``) is called on rank 0's
    blocks, which the arch's ``place_inputs`` cuts: its compute is sharded
    (``compute="sharded"`` in the record).
  * Every other step runs through ``distributed.sharding.sharded_step``,
    which gathers each argument whole on every rank and runs the arch's
    own step there.  A rank's compute is the whole step
    (``compute="replicated"``), so at 256 ranks ``useful_flops_ratio`` is
    about 1/256 of the one-card ratio.

A cell the registry marks ``skip`` is recorded as the reference records it.
A step that reads the device on the host cannot run on ``meta`` tensors: it
is recorded ``skipped``, its reason naming the port's file:line of the
read.  Anything else is ``failed``, and the run exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only]
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.specs import TensorSpec
from repro_torch.distributed.sharding import place, sharded_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.roofline import analyze
from repro_torch.train.optimizer import AdamWState, init_adamw

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what a meta tensor raises where a step reads a value on the host:
# .item() / bool() / int(); .tolist() / .cpu(); .numpy(); torch.nonzero,
# torch.where(c) and a boolean index (all through nonzero's meta
# function); repeat_interleave with counts in a tensor
_HOST_READ_MESSAGES = ("cannot be called on meta tensors",
                       "Cannot copy out of meta tensor",
                       "can't convert meta device type tensor",
                       "torch.nonzero()",
                       "repeat_interleave a meta tensor without output_size")
# ops whose output shape is the data's, which have no meta function
_DATA_DEPENDENT_OPS = ("masked_select", "_unique2", "unique_dim",
                       "unique_consecutive")


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _model_flops(arch, cfg, shape: str) -> Optional[float]:
    if getattr(arch, "family", "") != "lm":
        return None
    from repro_torch.configs.lm_common import LM_SHAPES, model_flops
    spec = LM_SHAPES[shape]
    kind = spec["kind"]
    tokens = spec["batch"] * (spec["seq"] if kind != "decode" else 1)
    return model_flops(cfg, tokens, train=(kind == "train"))


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks, joined as rank
    0: its collectives move nothing and return at once."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(spec: TensorSpec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def meta_inputs(arch, cfg, shape: str, reduced: bool = False) -> tuple:
    """The step's whole arguments on ``meta``: the model from
    ``arch.module(cfg)`` (never ``init``), AdamW state from
    :func:`init_adamw`, every other :class:`TensorSpec` of
    ``abstract_inputs`` (at the REDUCED shapes with ``reduced``) as an
    empty ``meta`` tensor."""
    abstract = arch.abstract_inputs(cfg, shape, reduced=reduced)
    model = arch.module(cfg) if hasattr(arch, "module") else None

    def build(x):
        if isinstance(x, TensorSpec):
            return _meta(x)
        if isinstance(x, AdamWState):
            return init_adamw(model)
        if isinstance(x, dict):
            return {k: build(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(build(v) for v in x)
        return x

    if model is None:
        return tuple(build(a) for a in abstract)
    return (model,) + tuple(build(a) for a in abstract[1:])


def is_host_read(exc: BaseException) -> bool:
    """Whether ``exc`` is what a ``meta`` tensor raises where a step reads
    a value on the host or asks for an output shaped by the data
    (``.item()``, ``.tolist()``, ``nonzero``, a boolean index,
    ``masked_select``, ``unique``, ``repeat_interleave``).  Any other error, a
    ``NotImplementedError`` of an unsupported op or a stub included, is
    not."""
    msg = str(exc)
    return (any(m in msg for m in _HOST_READ_MESSAGES)
            or any(f"aten::{op}: attempted to run this operator with Meta"
                   in msg for op in _DATA_DEPENDENT_OPS))


def host_read_site(exc: BaseException) -> str:
    """``models/recsys.py:575``: the innermost frame of ``exc``'s traceback
    inside the port's package, outside this launcher and the counter."""
    site = "?"
    for fr in traceback.extract_tb(exc.__traceback__):
        path = os.path.abspath(fr.filename)
        if not path.startswith(PKG_DIR + os.sep):
            continue
        rel = os.path.relpath(path, PKG_DIR)
        if rel in (os.path.join("launch", "dryrun.py"),
                   os.path.join("launch", "op_cost.py")):
            continue
        site = f"{rel}:{fr.lineno}"
    return site


def rank_step(arch, cfg, shape: str, mesh, step, whole: tuple,
              in_specs=None) -> tuple:
    """(step, args, compute): how one rank of ``mesh`` runs ``step`` on
    the whole arguments ``whole``.  A ``mesh_explicit`` step runs on the
    rank's blocks from ``arch.place_inputs`` (``"sharded"``); any other
    runs through :func:`sharded_step` on the blocks ``in_specs`` (default:
    the arch's ``in_shardings``) cut (``"replicated"``).  The blocks of a
    module are cut in place, so ``whole`` serves one call."""
    if getattr(step, "mesh_explicit", False):
        return step, arch.place_inputs(shape, mesh, *whole), "sharded"
    if in_specs is None:
        in_specs = arch.in_shardings(cfg, shape, mesh)
    return (sharded_step(step, mesh, in_specs),
            place(whole, in_specs, mesh), "replicated")


def count_call(step, args) -> tuple:
    """(counter, seconds): ``step(*args)`` run once under an
    :class:`OpCounter` that holds its arguments and outputs."""
    counter = OpCounter()
    counter.add_arguments(args)
    t0 = time.perf_counter()
    with counter:
        out = step(*args)
    count_s = time.perf_counter() - t0
    counter.add_outputs(out)
    return counter, count_s


def _write(rec: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch_id: str, shape: str, multi_pod: bool, out_dir: str,
             verbose: bool = True) -> dict:
    """Count one rank's step of a cell on the production mesh of the
    existing process group and write its record."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    arch = get_arch(arch_id)
    cell = {c.shape: c for c in arch.cells()}[shape]
    tag = f"{arch_id}__{shape}__{_mesh_tag(multi_pod)}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    head = dict(arch=arch_id, shape=shape, mesh=_mesh_tag(multi_pod))

    if cell.skip:
        rec = dict(head, status="skipped", reason=cell.skip)
        _write(rec, path)
        if verbose:
            print(f"[skip] {tag}: {cell.skip}")
        return rec

    cfg = arch.config(reduced=False, shape=shape)
    whole = meta_inputs(arch, cfg, shape)
    kw = {}
    if "mesh" in inspect.signature(arch.step_fn).parameters:
        kw["mesh"] = mesh
    step, args, compute = rank_step(arch, cfg, shape, mesh,
                                    arch.step_fn(cfg, shape, **kw), whole)
    del whole

    try:
        counter, count_s = count_call(step, args)
    except Exception as e:  # noqa: BLE001 - sorted below
        if not is_host_read(e):
            raise
        site = host_read_site(e)
        reason = (f"reads the device on the host at {site} "
                  f"({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        rec = dict(head, status="skipped", reason=reason)
        _write(rec, path)
        if verbose:
            print(f"[skip] {tag}: {reason}")
        return rec

    roof = analyze(counter, model_flops=_model_flops(arch, cfg, shape))
    rec = dict(head, chips=chips, status="ok", compute=compute,
               count_s=round(count_s, 2), ops=counter.ops,
               dot_flops_per_chip=counter.dot_flops,
               memory_analysis=counter.memory,
               roofline=roof.to_dict(chips), kernels=counter.kernels)
    _write(rec, path)
    if verbose:
        r = rec["roofline"]
        print(f"[ok]   {tag}: count {count_s:.1f}s {counter.ops} ops | "
              f"Tc {r['t_compute']:.2e} Tm {r['t_memory']:.2e} "
              f"Tx {r['t_collective']:.2e} -> {r['bottleneck']}",
              flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args(argv)

    arch_ids = [args.arch] if args.arch else ARCH_IDS
    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for mp in meshes:
        with fake_group(512 if mp else 256):
            for arch_id in arch_ids:
                arch = get_arch(arch_id)
                shapes = ([args.shape] if args.shape
                          else [c.shape for c in arch.cells()])
                for shape in shapes:
                    try:
                        run_cell(arch_id, shape, mp, args.out)
                    except Exception as e:  # noqa: BLE001 - recorded
                        tag = f"{arch_id}__{shape}__{_mesh_tag(mp)}"
                        print(f"[FAIL] {tag}: {e}")
                        traceback.print_exc()
                        failures.append(tag)
                        _write(dict(arch=arch_id, shape=shape,
                                    mesh=_mesh_tag(mp), status="failed",
                                    error=str(e)),
                               os.path.join(args.out, tag + ".json"))
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("\nall dry-run cells counted")


if __name__ == "__main__":
    main()
