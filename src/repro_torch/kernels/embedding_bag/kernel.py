"""Launcher of the embedding_bag CUDA kernel (``csrc/embedding_bag.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas``.  The
source's header says what bounds the kernel on an H100 and what its design
does about it.  Like the TPU kernel it is forward only; the op's backward
is plain PyTorch (``ops.py``).  :func:`launch_shape` picks how a launch
splits the bags' columns over warps and the warps over blocks.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import loader

from .ref import MODES

SMS = 132                 # streaming multiprocessors of an H100 SXM
MAX_WARPS_PER_BAG = 4     # kMaxWarpsPerBag in embedding_bag.cu
BLOCK_WARPS = (8, 4, 2)   # warps a block, at most kMaxWarpsPerBlock = 8
SLICE_QUANTUM = 8         # kSliceQuantum: a slice is a multiple of 8 columns


class LaunchShape(NamedTuple):
    """A bag's columns in ``warps_per_bag`` slices of ``slice_cols``
    columns (the last may be ragged), ``warps_per_block`` warps a block,
    ``blocks`` blocks."""
    warps_per_bag: int
    slice_cols: int
    warps_per_block: int
    blocks: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def launch_shape(b: int, d: int, dtype: torch.dtype) -> LaunchShape:
    """The launch shape of ``b`` bags of a (V, ``d``) table of ``dtype``.

    A warp's pass covers 32 lanes of one 16-byte element (4 fp32 or 8
    16-bit columns; 4 scalar columns when ``d`` does not split into such
    elements).  Each bag gets one warp per pass, at most 4, each on whole
    passes; when that gives fewer warps than SMs, the slices are halved
    (down to 8 columns) up to 4 warps a bag.  Blocks take the most warps
    (8, 4, 2 or 1) that still leave two blocks an SM, so a few hundred bags
    spread over the card."""
    if b < 1 or d < 1:
        raise ValueError(f"launch_shape: b = {b}, d = {d}")
    vec = 16 // dtype.itemsize
    pass_cols = 32 * (vec if d % vec == 0 else 4)
    passes = _ceil(d, pass_cols)
    warps = min(MAX_WARPS_PER_BAG, passes)
    slice_cols = _ceil(passes, warps) * pass_cols
    while (2 * warps <= MAX_WARPS_PER_BAG and b * warps < SMS
           and _ceil(d, 2 * warps) >= SLICE_QUANTUM):
        warps *= 2
        slice_cols = _ceil(_ceil(d, warps), SLICE_QUANTUM) * SLICE_QUANTUM
    warps = _ceil(d, slice_cols)        # no empty slice
    total = b * warps
    per_block = next((w for w in BLOCK_WARPS if _ceil(total, w) >= 2 * SMS),
                     1)
    return LaunchShape(warps, slice_cols, per_block, _ceil(total, per_block))


def embedding_bag_cuda(ids: torch.Tensor, table: torch.Tensor,
                       mode: str = "sum") -> torch.Tensor:
    """ids (B, L) int32 (-1 padded), table (V, D) fp32, bf16 or fp16 ->
    (B, D) in the table's dtype, as :func:`embedding_bag_ref` returns it
    (a 16-bit table summed and divided in fp32, rounded once).

    CUDA tensors only, contiguous; any other dtype raises ``TypeError``
    (no cast).  Raises ``ValueError`` for a mode other than ``"sum"`` and
    ``"mean"`` and for an empty table.  Adds one to
    ``embedding_bag_cuda.launches`` per kernel launch."""
    if mode not in MODES:
        raise ValueError(mode)
    loader.check_tensors("embedding_bag_cuda", table.device,
                         [("ids", ids, torch.int32, 2),
                          ("table", table, loader.floats(), 2)])
    b, l = ids.shape
    v, d = table.shape
    if v < 1:
        raise ValueError("embedding_bag_cuda: the table has no rows")
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = loader.library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.repro_embedding_bag_shaped(
            ids.data_ptr(), table.data_ptr(), out.data_ptr(), b, l, v, d,
            int(mode == "mean"), loader.float_code(table),
            *launch_shape(b, d, table.dtype), stream)
        embedding_bag_cuda.launches += 1
    loader.check(rc, "embedding_bag")
    return out


embedding_bag_cuda.launches = 0
