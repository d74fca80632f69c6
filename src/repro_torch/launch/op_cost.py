"""Per-op cost counting of an eager step (the twin of
``repro/launch/hlo_cost.py``).

The reference compiles each step and re-derives FLOPs, bytes and
collective bytes from the compiled HLO text.  The port has no compiled
program: its step runs eagerly, op by op.  :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten op the step dispatches (after
autograd and after composite ops are decomposed), runs it, and counts it.
On ``meta`` tensors nothing is computed or allocated, so a full-width step
is counted on the host in seconds.

Cost model (``hlo_cost.py``'s, op by op):
  flops: dot-class ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``dot``,
         ``mv``, ``addmv``; ``einsum``, ``matmul`` and ``linear`` reach
         these) = 2·|out|·K; every other computing op (elementwise,
         reductions, sorts) = |out|.  FLOPs are kept by dtype class
         (:data:`repro_torch.launch.roofline.PEAKS`): a dot's by its
         operand, any other op's by its first floating output.
  bytes: per op, operands + outputs, each tensor counted by the elements
         its strides reach (an expanded view reads its source once);
         indexed reads and writes (``index_select``, ``gather``,
         ``embedding``, ``index.Tensor``, ``index_add_``, ``scatter*``,
         ``index_put_``) cost 2·|rows moved| plus the index bytes, not
         the whole table.
  free:  views and metadata ops (``view``, ``transpose``, ``expand``,
         ``detach``, ``empty``, ...).
  collectives (``c10d`` ops): max(in, out) bytes, x2 for all-reduce, kept
         by kind with counts (the reference's ring model).
  kernels: a kernel router given ``meta`` tensors computes nothing and
         reports its kernel's dense cost through
         :func:`repro_torch.kernels.cost.record_kernel`, which every
         counter collecting then listens to.

Where the port differs from the reference:
  * no fusion: the bytes are the eager program's per-op traffic (each
    intermediate written by one op and read by the next), not the fused
    program's; L2 may hold one op's output for the next, so this counts
    HBM traffic from above;
  * no trip counts: every loop iteration, and a checkpoint's recompute
    under backward, is dispatched, so each is counted as it runs.

:attr:`OpCounter.memory` is the twin of ``compiled.memory_analysis()``:
argument bytes, output bytes and the peak of live bytes over the step,
tracked by storage (a storage counts from the op that makes it until it is
freed).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost as kernel_cost

Tensor = torch.Tensor

# dot-class ops: 2·|out|·K, K the contracted size (the last dim of the
# first matrix operand)
_DOT = {"mm": 0, "bmm": 0, "dot": 0, "mv": 0,
        "addmm": 1, "baddbmm": 1, "addmv": 1, "addbmm": 1}
# indexed reads: 2·|out| + index bytes
_INDEXED_READ = {"index_select", "gather", "embedding", "index", "take"}
# indexed writes: 2·|values| + index bytes (the argument of the values)
_INDEXED_WRITE = {"index_add": 3, "index_add_": 3, "index_copy": 3,
                  "index_copy_": 3, "scatter": 3, "scatter_": 3,
                  "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3,
                  "scatter_reduce_": 3, "index_put": 2, "index_put_": 2,
                  "_index_put_impl_": 2}
# metadata and allocation without a write
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
         "resize_", "_unsafe_view", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
         "record_stream", "_local_scalar_dense"}
# data movement: bytes only
_MOVE = {"copy_", "_to_copy", "clone", "cat", "stack", "constant_pad_nd",
         "flip", "roll", "repeat", "zero_", "fill_", "zeros", "ones", "full",
         "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
         "new_full", "scalar_tensor", "arange", "slice_scatter",
         "select_scatter", "as_strided_scatter"}
# c10d op name prefix -> the reference's collective kind
_COLLECTIVE_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
                     ("allgather", "all-gather"), ("_allgather", "all-gather"),
                     ("all_gather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("_reduce_scatter", "reduce-scatter"),
                     ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"),
                     ("broadcast", "broadcast"), ("reduce_", "reduce"),
                     ("gather_", "gather"), ("scatter_", "scatter"))
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

def dtype_class(dtype: torch.dtype) -> str:
    """The FLOP class a dtype is timed in (``roofline.PEAKS``' keys)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "fp32"
    return "other"


def tensor_bytes(t: Tensor) -> int:
    """Bytes of the elements a tensor's strides reach: a dim of stride 0
    (an expanded view) is read once, not once per index."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(x) -> List[Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, Tensor)]


def _sum_bytes(ts) -> int:
    return sum(tensor_bytes(t) for t in ts)


def _collective_kind(name: str) -> Optional[str]:
    if name in ("barrier", "monitored_barrier_", "wait_tensor"):
        return None
    for prefix, kind in _COLLECTIVE_KINDS:
        if name.startswith(prefix):
            return kind
    return name


class OpCounter(TorchDispatchMode):
    """Counts FLOPs (by dtype class), bytes, collectives, kernels and live
    storage of every op dispatched inside ``with OpCounter() as c:``.

    ``flops`` {class: FLOPs}, ``dot_flops`` (the dot-class share),
    ``bytes``, ``coll_bytes``, ``coll`` {kind: {"count", "bytes"}},
    ``kernels`` {name: {"count", "flops", "bytes"}}, ``ops`` (ops
    counted), ``by_op`` {aten op: {"count", "flops", "bytes"}}, and
    :attr:`memory` after :meth:`add_arguments` / :meth:`add_outputs`.
    Counters may nest; each counts every op inside it."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = {"bf16": 0.0, "fp32": 0.0,
                                        "other": 0.0}
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = 0.0
        self.coll: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[str, Dict[str, float]] = {}
        self.ops = 0
        self._sizes: Dict[int, int] = {}     # live storage -> bytes
        self._args: set = set()              # argument storages
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        kernel_cost.LISTENERS.append(self.add_kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.LISTENERS.remove(self.add_kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    # -- counting ----------------------------------------------------------
    def _add(self, name: str, flops: float, nbytes: float, cls: str) -> None:
        self.ops += 1
        self.flops[cls] += flops
        self.bytes += nbytes
        rec = self.by_op.setdefault(name, {"count": 0, "flops": 0.0,
                                           "bytes": 0.0})
        rec["count"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes

    def _count(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        name = func.overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._collective(name, args)
            return
        if func.is_view or name in _FREE:
            return
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        if name in _DOT:
            a = args[_DOT[name]]
            flops = 2.0 * outs[0].numel() * a.shape[-1]
            self.dot_flops += flops
            self._add(name, flops, _sum_bytes(ins) + _sum_bytes(outs),
                      dtype_class(a.dtype))
            return
        if name in _INDEXED_READ:
            idx = [t for t in ins if t is not args[0]]
            self._add(name, 0.0, 2.0 * _sum_bytes(outs) + _sum_bytes(idx),
                      dtype_class(outs[0].dtype))
            return
        if name in _INDEXED_WRITE:
            vals = _tensors(args[_INDEXED_WRITE[name]]
                            if len(args) > _INDEXED_WRITE[name] else ())
            idx = [t for t in ins if t is not args[0]
                   and all(t is not v for v in vals)]
            self._add(name, 0.0, 2.0 * _sum_bytes(vals) + _sum_bytes(idx),
                      dtype_class(args[0].dtype))
            return
        if name == "embedding_dense_backward":
            # the dense gradient table is written whole (zeros), then the
            # gradient rows are added into the rows the ids name
            g, ids = args[0], args[1]
            self._add(name, float(g.numel()), _sum_bytes(outs)
                      + 2.0 * tensor_bytes(g) + tensor_bytes(ids),
                      dtype_class(g.dtype))
            return
        nbytes = _sum_bytes(ins) + _sum_bytes(outs)
        if name in _MOVE:
            self._add(name, 0.0, nbytes, "other")
            return
        flops = float(sum(t.numel() for t in outs))
        floating = [t for t in outs if t.is_floating_point()]
        cls = dtype_class(floating[0].dtype) if floating else "other"
        self._add(name, flops, nbytes, cls)

    def _collective(self, name: str, args) -> None:
        kind = _collective_kind(name)
        if kind is None:
            return
        first = _sum_bytes(_tensors(args[0])) if args else 0
        second = _sum_bytes(_tensors(args[1])) if len(args) > 1 else 0
        b = float(max(first, second))
        if kind == "all-reduce":
            b *= 2.0
        self.coll_bytes += b
        rec = self.coll.setdefault(kind, {"count": 0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += b
        self._add(f"c10d.{name}", 0.0, float(first + second), "other")

    def add_kernel(self, name: str, flops: float, nbytes: float,
                   dtype: torch.dtype = torch.float32) -> None:
        self._add(f"kernel.{name}", float(flops), float(nbytes),
                  dtype_class(dtype))
        rec = self.kernels.setdefault(name, {"count": 0, "flops": 0.0,
                                             "bytes": 0.0})
        rec["count"] += 1
        rec["flops"] += float(flops)
        rec["bytes"] += float(nbytes)

    # -- memory ------------------------------------------------------------
    def _track(self, t: Tensor) -> Optional[int]:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return key
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def add_arguments(self, tree: Any) -> None:
        """Count the step's arguments (tensors and modules' parameters) as
        live from the start: call before the step, inside or outside the
        mode."""
        for t in _tree_tensors(tree):
            key = self._track(t)
            if key not in self._args:
                self._args.add(key)
                self.argument_bytes += self._sizes[key]

    def add_outputs(self, tree: Any) -> None:
        """Split the step's outputs into new bytes and bytes that alias an
        argument (an update in place): call after the step."""
        seen = set()
        for t in _tree_tensors(tree):
            key = t.untyped_storage()._cdata
            if key in seen:
                continue
            seen.add(key)
            n = t.untyped_storage().nbytes()
            if key in self._args:
                self.alias_bytes += n
            else:
                self.output_bytes += n

    @property
    def memory(self) -> Dict[str, int]:
        """The twin of ``memory_analysis()``, per rank, in bytes."""
        return dict(argument_size_in_bytes=self.argument_bytes,
                    output_size_in_bytes=self.output_bytes,
                    alias_size_in_bytes=self.alias_bytes,
                    peak_live_size_in_bytes=self.peak,
                    temp_size_in_bytes=max(self.peak - self.argument_bytes,
                                           0))


def _tree_tensors(tree: Any) -> List[Tensor]:
    """The tensors of a tree of dicts, tuples, named tuples and modules
    (a module's parameters and buffers)."""
    out: List[Tensor] = []

    def walk(x):
        if isinstance(x, Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(p.data for p in x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(tree)
    return out

