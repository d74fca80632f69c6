"""Distributed primitives on ``torch.distributed``: the device mesh, the
deterministic cross-shard top-k merge and its gathered forms.

The reference is single-controller: one process runs ``shard_map`` over a
``Mesh`` of its local devices.  The port is multi-controller, as PyTorch
is.  A mesh device is a rank of the default process group, each on one
device (``cuda:LOCAL_RANK`` under NCCL, the CPU under gloo), and every rank
runs the same program:

  * every rank calls an SPMD entry point with the same host-level inputs
    the reference's one process passes;
  * an input the reference specs ``P(axis)`` is cut by the rank's
    coordinate along ``axis`` (:meth:`Mesh.block`); ``P()`` is replicated;
  * every output the reference returns whole comes back whole, and
    identical, on every rank: merged candidates are all-gathered along
    the mesh dim that split them, batch slices along ``data``, in rank
    order (:func:`all_gather_cat`);
  * ranks outside a mesh smaller than the group take the mesh's result by
    a broadcast from rank 0 (:meth:`Mesh.share`).

Meshes are built once per shape (:func:`get_mesh`): building one creates
process groups, a collective call every rank makes in the same order.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor
Axes = Union[str, Tuple[str, ...]]

_MESHES: Dict[tuple, "Mesh"] = {}


def group_initialized() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A device mesh over ranks ``0 … size−1`` of the default process group,
    laid out row-major as ``np.asarray(devs).reshape(shape)`` lays out the
    reference's, with named dims.

    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh``
    behind it.  A mesh of one device without a process group has none: its
    gathers are the identity, which is what a size-1 axis computes.  A
    larger mesh without a group raises ``ValueError``.  ``coordinate`` is
    this rank's position, ``None`` on a rank outside the mesh.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or min(self.shape) < 1:
            raise ValueError(f"mesh shape {self.shape} / axes "
                             f"{self.axis_names}")
        self.devices = np.arange(math.prod(self.shape)).reshape(self.shape)
        self.size = int(self.devices.size)
        if group_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if self.size > self.world:
                raise ValueError(
                    f"a {self.shape} mesh needs {self.size} ranks but the "
                    f"process group has {self.world}")
            # held, so that the group's id (a cache key) is never reused
            self.world_group = dist.group.WORLD
            from torch.distributed.device_mesh import DeviceMesh
            kind = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
            self.device_mesh = DeviceMesh(kind, self.devices,
                                          mesh_dim_names=self.axis_names)
        else:
            if self.size != 1:
                raise ValueError(
                    f"a {self.shape} mesh of {self.size} devices needs an "
                    "initialised default process group (one rank per "
                    "device: torchrun, or torch.distributed."
                    "init_process_group)")
            self.rank, self.world = 0, 1
            self.device_mesh = None
        self.coordinate: Optional[Tuple[int, ...]] = (
            tuple(int(c) for c in np.unravel_index(self.rank, self.shape))
            if self.rank < self.size else None)

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank}/{self.world})")

    def axis_size(self, axes: Axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[self.axis_names.index(a)] for a in axes)

    def axis_index(self, axes: Axes) -> int:
        """This rank's row-major index over ``axes`` (one name or several,
        as ``P(("pod", "data"))`` splits a dim over several)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coordinate[i]
        return idx

    def block(self, n: int, axes: Axes) -> slice:
        """This rank's block of a length-``n`` dim split over ``axes``."""
        parts = self.axis_size(axes)
        if n % parts:
            raise ValueError(f"a dim of {n} does not split evenly over "
                             f"{parts} devices of mesh axes {axes}")
        b = n // parts
        i = self.axis_index(axes)
        return slice(i * b, (i + 1) * b)

    def group(self, axis: str):
        """The process group of ``axis`` through this rank, or ``None``
        on a mesh without a process group."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def share(self, outs: Optional[Sequence[Tensor]],
              like: Sequence[Tuple[tuple, torch.dtype]],
              device) -> Tuple[Tensor, ...]:
        """The mesh's outputs on every rank of the group: a no-op where the
        mesh spans the group; else rank 0 broadcasts ``outs`` and a rank
        outside the mesh (``outs`` is ``None`` there) receives them into
        tensors of the ``like`` (shape, dtype) on ``device``."""
        if self.size == self.world:
            return tuple(outs)
        if outs is None:
            outs = [torch.empty(shape, dtype=dtype, device=device)
                    for shape, dtype in like]
        outs = [t.contiguous() for t in outs]
        for t in outs:
            dist.broadcast(t, src=0)
        return tuple(outs)


def get_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The cached :class:`Mesh` of ``shape`` / ``axis_names`` over the
    current default group (the reference's ``_MESHES``)."""
    world = ((dist.get_world_size(), id(dist.group.WORLD))
             if group_initialized() else None)
    key = (tuple(shape), tuple(axis_names), world)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = Mesh(shape, axis_names)
    return mesh


def all_gather_cat(t: Tensor, mesh: Mesh, axis: str, dim: int) -> Tensor:
    """All-gather ``t`` along mesh ``axis`` and concatenate the parts on
    ``dim`` in rank order: ``jax.lax.all_gather(t, axis, axis=dim,
    tiled=True)``.  The list form of ``dist.all_gather`` is used, which
    every torch version has."""
    g = mesh.group(axis)
    if g is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, t, group=g)
    return torch.cat(parts, dim=dim)


def gather_axes(t: Tensor, mesh: Mesh, axes: Axes, dim: int) -> Tensor:
    """Undo a split of ``dim`` over ``axes`` (one name or several, in
    :meth:`Mesh.axis_index` order): gather the innermost axis first."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in reversed(axes):
        t = all_gather_cat(t, mesh, a, dim)
    return t


# ---------------------------------------------------------------------------
# tie-stable selection and the deterministic cross-shard top-k merge
# ---------------------------------------------------------------------------


def top_k(s: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last dim of a 2-D fp32 ``s``: the k largest
    values, sorted descending, the lower index first among equal values
    (``-inf`` included), -0.0 below +0.0 as in XLA's total order.

    ``torch.topk`` promises no order among ties, so it selects on unique
    int64 keys instead: the score's bits mapped to an int32 of the same
    order in the high word, the complement of the index in the low word.
    Equal scores give equal high words, so the lower index has the larger
    key; no two keys of a row are equal, so the selection and its order
    are determined.  No host synchronisation."""
    if s.dtype != torch.float32:
        raise TypeError(f"top_k takes float32 scores, got {s.dtype}")
    bits = s.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)          # float order as int32
    low = 0xFFFFFFFF - torch.arange(s.shape[1], device=s.device,
                                    dtype=torch.int64)
    _, pos = torch.topk(key.to(torch.int64) * (1 << 32) + low, k, dim=1,
                        largest=True, sorted=True)
    return torch.gather(s, 1, pos), pos


def merge_topk(ids: Tensor, d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Deterministic cross-shard top-k merge over concatenated candidates.

    ids (B, C) int32 global ids (-1 = invalid), d (B, C) distances (invalid
    candidates carry ``inf``).  Each row is ordered by the lexicographic
    (distance, global id) key — two stable sorts, by id and then by
    distance, as torch has no lexsort — so the merge is invariant to shard
    arrival order and equal-distance ties always resolve the same way
    (smallest global id first; -0.0 and +0.0 are equal).  Exact duplicate
    candidates — the same (id, distance) pair contributed twice, e.g. by a
    duplicate-dispatch mirror of a shard — are collapsed to one entry, so
    mirrored dispatch never crowds real neighbors out of the top k.
    Non-finite distances come back as id ``-1`` / ``inf``.
    """
    by_id = torch.argsort(ids, dim=1, stable=True)
    d1 = torch.gather(d, 1, by_id)
    order = torch.gather(by_id, 1, torch.argsort(d1, dim=1, stable=True))
    s_ids = torch.gather(ids, 1, order)
    s_d = torch.gather(d, 1, order)
    # exact (id, distance) duplicates are adjacent after the sort; keep the
    # first of each run (invalid entries are already id -1 / inf)
    dup = torch.zeros_like(s_ids, dtype=torch.bool)
    dup[:, 1:] = ((s_ids[:, 1:] == s_ids[:, :-1])
                  & (s_d[:, 1:] == s_d[:, :-1]) & (s_ids[:, 1:] >= 0))
    s_d = torch.where(dup, torch.full_like(s_d, float("inf")), s_d)
    # survivors are already (distance, id)-sorted; a stable sort floats the
    # invalidated duplicates past the real candidates without reordering
    order2 = torch.argsort(s_d, dim=1, stable=True)[:, :k]
    out_d = torch.gather(s_d, 1, order2)
    out_ids = torch.where(torch.isfinite(out_d),
                          torch.gather(s_ids, 1, order2),
                          torch.full_like(out_d, -1, dtype=ids.dtype))
    return out_ids, out_d


def gathered_topk_merge(ids: Tensor, d: Tensor, k: int, axis: str,
                        mesh: Mesh) -> Tuple[Tensor, Tensor]:
    """Global top-k merge along mesh ``axis``, called by every rank of the
    mesh.

    Each rank contributes its local top candidates ids/d (B_local, k');
    an all-gather along ``axis`` (k' entries per shard, concatenated on
    dim 1 in rank order, as the reference's tiled gather) feeds the
    deterministic :func:`merge_topk`, so every rank computes the identical
    merged (B_local, k) result (replicated along ``axis``)."""
    i_all = all_gather_cat(ids, mesh, axis, dim=1)   # (B, P*k')
    d_all = all_gather_cat(d, mesh, axis, dim=1)
    return merge_topk(i_all, d_all, k)


def sharded_topk(mesh: Mesh, dp: Axes, tp: str = "model"):
    """Returns ``make(k)`` -> ``f(scores (B, N), ids (B, N))`` -> (ids,
    scores) (B, k): the global top-k, score-descending, ties broken by
    smallest id.

    Every rank passes the whole arrays; it cuts its block — rows by its
    ``dp`` coordinate, columns by its ``tp`` coordinate, the reference's
    ``P(dp, tp)`` — takes the local top-k (:func:`top_k`), merges along
    ``tp`` (:func:`gathered_topk_merge`) and all-gathers the rows along
    ``dp``, so every rank returns the whole result."""

    def make(k: int):
        def apply(scores: Tensor, ids: Tensor):
            b = scores.shape[0]
            coord = mesh.coordinate
            outs = None
            if coord is not None:
                rows = mesh.block(b, dp)
                cols = mesh.block(scores.shape[1], tp)
                s, pos = top_k(scores[rows, cols], k)
                i = torch.gather(ids[rows, cols], 1, pos)
                # scores maximize; merge_topk minimizes distances — negate
                mi, md = gathered_topk_merge(i, -s, k, tp, mesh)
                outs = (gather_axes(mi, mesh, dp, 0),
                        gather_axes(-md, mesh, dp, 0))
            mi, ms = mesh.share(outs, [((b, k), ids.dtype),
                                       ((b, k), scores.dtype)],
                                scores.device)
            return mi, ms

        return apply

    return make
