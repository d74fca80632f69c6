"""Launcher of the filtered_topk CUDA kernel (``csrc/filtered_topk.cu``).

Replaces the Pallas TPU kernel
``repro/kernels/filtered_topk/kernel.py::filtered_topk_pallas`` together
with the ``lax.top_k`` reduction over its tiles in ``ops.py``.  One launch
per call for k <= :data:`KMAX`: a CTA per (query, 2048-row tile) scores
the rows its mask passes, ranks its keys, raises the query's running
k-th-key threshold and publishes its keys at or above it, sorted; the last
CTA of each query (an arrival counter) selects the exact top k of what was
published.  Above :data:`KMAX`, every k <= n: per chunk of queries, the
tiles write every row's key to the workspace, then one CTA per query
radix-selects its k-th key and sorts the keys at or above it (bitonic in
shared memory, merged in global memory past 16,384 keys).  x is fp32, bf16
or fp16 and so is q; 16-bit rows are read as stored and scored in fp32.
The source's header says what bounds the kernel on an H100 and what its
design does about it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import loader

# largest k of the one-launch design (csrc/filtered_topk.cu, kMaxK); larger
# k take the select-and-sort path
KMAX = 256

# per (device, stream): the kernel's per-query state (running threshold and
# arrival count, 2 int64 words a query), zeroed once; each call leaves it
# zero again, so calls queued on one stream can share it
_STATE: Dict[Tuple[int, int], torch.Tensor] = {}


def _state(b: int, device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    st = _STATE.get(key)
    if st is None or st.numel() < 2 * b:
        # a larger buffer replaces the old one; queued calls that use the
        # old one run first (same stream), so freeing it is safe
        st = _STATE[key] = torch.zeros(2 * b, dtype=torch.int64,
                                       device=device)
    return st


def filtered_topk_cuda(q: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                       k: int, metric: str = "l2"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, d), x (n, d) fp32, bf16 or fp16, mask (B, n) bool -> (ids
    (B, k) int32, dists (B, k) f32), as :func:`filtered_topk_ref` returns
    them.

    CUDA tensors only, contiguous; any other dtype raises ``TypeError``
    (no cast).  Raises ``ValueError`` for k < 0 and k > n.  Adds one to
    ``filtered_topk_cuda.launches`` per call that launches the kernel."""
    if metric not in ("l2", "ip"):
        raise ValueError(metric)
    loader.check_tensors("filtered_topk_cuda", q.device,
                         [("q", q, loader.floats(), 2),
                          ("x", x, loader.floats(), 2),
                          ("mask", mask, torch.bool, 2)])
    b, d = q.shape
    n = x.shape[0]
    if x.shape[1] != d or mask.shape != (b, n):
        raise ValueError(f"filtered_topk_cuda: shapes q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}, mask {tuple(mask.shape)}")
    if k > n:
        raise ValueError(f"filtered_topk: k = {k} > n = {n}")
    if k < 0:
        raise ValueError(f"filtered_topk_cuda: k = {k} < 0")
    ids = torch.empty((b, k), dtype=torch.int32, device=q.device)
    dists = torch.empty((b, k), dtype=torch.float32, device=q.device)
    if b == 0 or k == 0:
        return ids, dists
    lib = loader.library()
    # scratch for the tile lists (k <= KMAX) or one chunk's keys; freeing
    # it on return is safe: the caching allocator hands the block out again
    # only to work queued after this call on the same stream
    ws = torch.empty(lib.repro_filtered_topk_workspace(b, n, k),
                     dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        st = _state(b, q.device, stream)
        rc = lib.repro_filtered_topk(
            q.data_ptr(), x.data_ptr(), mask.data_ptr(), ids.data_ptr(),
            dists.data_ptr(), st.data_ptr(), ws.data_ptr(), b, n, d, k,
            int(metric == "ip"), loader.float_code(q), loader.float_code(x),
            stream)
        filtered_topk_cuda.launches += 1
    loader.check(rc, "filtered_topk")
    return ids, dists


filtered_topk_cuda.launches = 0
