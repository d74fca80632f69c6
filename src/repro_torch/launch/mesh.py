"""Mesh construction for launch scripts.

A mesh device is a rank of the default process group
(:mod:`repro_torch.distributed.collectives`); these build the meshes the
reference's launchers use, over the ranks the group has.  Functions, never
module-level constants, so importing this module creates no process group.
"""
from __future__ import annotations

from repro_torch.distributed.collectives import Mesh, get_mesh
from repro_torch.distributed.query_parallel import local_device_count


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 devices per pod ("data", "model"); 2 pods add a leading "pod"
    axis.  Raises ``ValueError`` unless the process group has exactly 256
    (or, with ``multi_pod``, 512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if local_device_count() != need:
        raise ValueError(
            f"the production mesh {shape} needs a process group of {need} "
            f"ranks, this one has {local_device_count()}")
    return get_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """A ("data", "model") mesh over every rank of the group (one device
    without a group); ``model_axis`` must divide the rank count."""
    n = local_device_count()
    if n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the {n} "
                         "devices")
    return get_mesh((n // model_axis, model_axis), ("data", "model"))


def dp_axes(mesh: Mesh) -> tuple:
    """The batch-parallel axes of a mesh (('pod',)? + ('data',))."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_corpus_serving_mesh(data: int, corpus: int) -> Mesh:
    """2-D ``(data, corpus)`` mesh for corpus-sharded hybrid-search serving:
    queries split along ``data``, one corpus shard per ``corpus`` device.
    The cached constructor of ``repro_torch.distributed.corpus_parallel``,
    so launch scripts and the serving engine share one mesh."""
    from repro_torch.distributed.corpus_parallel import corpus_mesh
    return corpus_mesh(data, corpus)
