"""Query-data-parallel dispatch of hybrid search over a ``data`` mesh.

The batched pipeline runs every bucket on one device; this module splits
a bucket's queries over a 1-D ``data`` mesh of ranks
(:mod:`repro_torch.distributed.collectives` says how ranks make a mesh):

  * queries ``xq`` and predicate ``pass_masks`` are cut by the rank's
    ``data`` coordinate;
  * the graph and the vector table are replicated (every rank holds them);
  * each rank runs its own independent search loop, so a converged rank's
    lanes stop paying for a straggler rank's hops;
  * ids, distances and both ``SearchStats`` fields are all-gathered along
    ``data`` in rank order, so every rank returns the whole batch.

Results are bit-identical to the single-device path: per-lane state
freezes on convergence, so a query's ids/dists/stats never depend on
which other queries share its device.  Bucket sizes must be multiples of
the mesh size — ``core/batched.py::plan_chunks(multiple_of=...)``
guarantees this for the bucketed dispatch.

Local testing: spawn ``N`` ranks in a ``gloo`` group on the CPU
(``tests/test_torch_query_parallel.py``); on cards, ``torchrun
--nproc-per-node N`` with ``nccl``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.search import SearchStats, _search_impl

from .collectives import Mesh, all_gather_cat, get_mesh, group_initialized


def local_device_count() -> int:
    """Devices a mesh can use: the ranks of the default process group, or
    1 without one."""
    return dist.get_world_size() if group_initialized() else 1


def resolve_data_parallel(requested: Optional[int]) -> int:
    """Clamp a data-parallel request to :func:`local_device_count`.

    ``None``/``0`` mean "all devices"; 1 selects the single-device path;
    anything larger is capped at what the group has.
    """
    ndev = local_device_count()
    if not requested:
        return ndev
    return max(1, min(int(requested), ndev))


def data_mesh(dp: int) -> Mesh:
    """A 1-D mesh over ranks ``0 … dp−1``, axis name ``data`` (cached)."""
    if dp > local_device_count():
        raise ValueError(f"data_parallel={dp} but only "
                         f"{local_device_count()} devices")
    return get_mesh((dp,), ("data",))


def sharded_search_fn(dp: int, has_mask: bool, statics: dict) -> Callable:
    """The data-sharded search callable of one variant.

    Returns ``f(graph, x, xq, masks)`` with the same signature and results
    as ``_search_impl(graph, x, xq, masks, **statics)``, called by every
    rank with the whole batch; each mesh rank searches its ``B / dp``
    queries (and masks, when ``has_mask``) and the results are gathered
    along ``data``.  ``xq.shape[0]`` must be a multiple of ``dp``.
    """
    mesh = data_mesh(dp)
    k = min(statics["k"], statics["ef"])   # the search returns min(k, ef)

    def f(graph, x, xq, masks):
        b = xq.shape[0]
        outs = None
        if mesh.coordinate is not None:
            rows = mesh.block(b, "data")
            ids, d, st = _search_impl(
                graph, x, xq[rows], masks[rows] if has_mask else None,
                **statics)
            outs = [all_gather_cat(t, mesh, "data", dim=0)
                    for t in (ids, d, st.dist_comps, st.hops)]
        ids, d, dcs, hops = mesh.share(
            outs, [((b, k), torch.int32), ((b, k), torch.float32),
                   ((b,), torch.int32), ((b,), torch.int32)], xq.device)
        return ids, d, SearchStats(dist_comps=dcs, hops=hops)

    return f


def pad_to_multiple(total: int, dp: int) -> int:
    """Smallest multiple of ``dp`` that is >= ``total``."""
    return ((total + dp - 1) // dp) * dp
