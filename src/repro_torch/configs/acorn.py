"""ACORN itself as a servable system config (the paper's contribution).

Two distributed serving cells on the corpus-sharded layout: corpus rows
split over every mesh axis, queries replicated, per-shard results merged
with a k-row all-gather:

  serve_1m   B=512 queries, n=2^20,   d=512 (LAION-1M scale)
  serve_25m  B=512 queries, n=3*2^23, d=512 (LAION-25M scale — Figure 11)

The step is the pre-filter / brute-force path (the route every query can
take).  Under the port's multi-controller mesh
(:mod:`repro_torch.distributed.collectives`) every rank calls the step
with its own row block of the corpus and the matching columns of the
masks: :meth:`AcornServeArch.place_inputs` cuts those blocks from whole
arrays by :meth:`AcornServeArch.in_shardings` and adds the block's first
row.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.collectives import Mesh, all_gather_cat, top_k
from repro_torch.distributed.sharding import P, place

from .specs import CellDef, TensorSpec

ACORN_SHAPES: Dict[str, Dict] = {
    "serve_1m": dict(kind="serve", batch=512, n=1 << 20, d=512, k=10),
    "serve_25m": dict(kind="serve", batch=512, n=3 << 23, d=512, k=10),
}

REDUCED_ACORN_SHAPES: Dict[str, Dict] = {
    "serve_1m": dict(kind="serve", batch=8, n=2048, d=32, k=10),
    "serve_25m": dict(kind="serve", batch=8, n=4096, d=32, k=10),
}

# queries a block of the mask draw covers (keeps its fp32 uniforms small)
_MASK_BLOCK = 16


class AcornServeArch:
    family = "acorn"
    name = "acorn"

    def config(self, reduced: bool = False, shape: Optional[str] = None):
        return None

    def cells(self):
        return [CellDef(s, "serve") for s in ACORN_SHAPES]

    def step_fn(self, cfg, shape: str, reduced: bool = False,
                mesh: Optional[Mesh] = None, k: int = 10,
                optimized: bool = False, chunk: int = 8192):
        """``serve(x_l, queries, masks_l, base=0)`` -> (ids, dists) (B, k),
        whole and identical on every rank of ``mesh``.

        ``x_l`` (n_l, d) is the rank's row block of the corpus, ``masks_l``
        (B, n_l) the matching mask columns, ``base`` the block's first row;
        queries (B, d) are replicated.  Scores are ``2·q·x − ‖x‖²`` in fp32
        (rank-equal to −‖q − x‖²); an id is −1 where its score is not
        finite; distances are ``‖q‖² − score``.  Selections are
        :func:`repro_torch.distributed.collectives.top_k` (the lower index
        first among equal scores, as ``lax.top_k``).  Matmuls run in fp32
        with TF32 off, torch's default
        (``torch.backends.cuda.matmul.allow_tf32``).

        ``optimized=False``: the paper-faithful baseline — the full (B, n_l)
        score matrix, masked, one top-k (the FAISS flat-scan pre-filter).
        ``optimized=True``: a scan over ``chunk``-row blocks with a running
        top-k: each block's own top-k first, then the ``[running, block]``
        concatenation, so the big score tile is never touched twice.

        A corpus of another dtype (bf16) is read as the reference reads
        it: the baseline promotes the product to fp32 (jnp's fp32 x bf16
        promotion) and sums the norms in the corpus dtype; the scan casts
        the queries to the corpus dtype, upcasts each block's product to
        fp32 and takes the norms of the block upcast to fp32."""
        if mesh is None:
            raise ValueError("the acorn serve step is mesh-explicit: pass "
                             "mesh= (e.g. launch.mesh.make_host_mesh())")
        axes = tuple(mesh.axis_names)

        def merge_global(qn, top_s, top_i, base):
            ids = (top_i + base).to(torch.int32)
            s = top_s
            for ax in axes:
                s = all_gather_cat(s, mesh, ax, dim=1)
                ids = all_gather_cat(ids, mesh, ax, dim=1)
            s2, pos = top_k(s, min(k, s.shape[1]))
            d2 = qn - s2
            ids2 = torch.gather(ids, 1, pos)
            return (torch.where(torch.isfinite(s2), ids2,
                                torch.full_like(ids2, -1)), d2)

        def scores(q, xb, xn, mb):
            # rank-equal -d2; a bf16 product is doubled exactly and meets
            # the fp32 norms in fp32
            s = 2.0 * (q @ xb.T) - xn[None, :]
            return torch.where(mb, s, torch.full_like(s, float("-inf")))

        def local_base(x_l, q, m_l, base):
            qn = (q * q).sum(dim=1, keepdim=True)
            xn = (x_l * x_l).sum(dim=1)
            xq = x_l.to(torch.promote_types(q.dtype, x_l.dtype))
            top_s, top_i = top_k(scores(q, xq, xn, m_l), k)
            return merge_global(qn, top_s, top_i, base)

        def local_opt(x_l, q, m_l, base):
            b, n_l = q.shape[0], x_l.shape[0]
            nc = max(n_l // chunk, 1)
            cs = n_l // nc
            qn = (q * q).sum(dim=1, keepdim=True)
            qf = q.to(x_l.dtype)
            bs = torch.full((b, k), float("-inf"), device=q.device)
            bi = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
            for i in range(nc):
                rows = slice(i * cs, (i + 1) * cs)
                xb = x_l[rows]
                xf = xb.float()
                # block-local top-k FIRST: the (B, 2k) merge never touches
                # the big score tile again
                ts_c, tp_c = top_k(scores(qf, xb, (xf * xf).sum(dim=1),
                                          m_l[:, rows]), k)
                ms = torch.cat([bs, ts_c], dim=1)
                mi = torch.cat([bi, tp_c + i * cs], dim=1)
                bs, tp = top_k(ms, k)
                bi = torch.gather(mi, 1, tp)
            return merge_global(qn, bs, bi, base)

        local = local_opt if optimized else local_base

        def serve(x_l, queries, masks_l, base: int = 0):
            b = queries.shape[0]
            outs = None
            if mesh.coordinate is not None:
                outs = local(x_l, queries, masks_l, base)
            return mesh.share(outs, [((b, k), torch.int32),
                                     ((b, k), torch.float32)],
                              queries.device)

        serve.mesh_explicit = True   # each rank passes its own blocks
        return serve

    def abstract_inputs(self, cfg, shape: str, reduced: bool = False):
        spec = (REDUCED_ACORN_SHAPES if reduced else ACORN_SHAPES)[shape]
        return (TensorSpec((spec["n"], spec["d"]), torch.float32),
                TensorSpec((spec["batch"], spec["d"]), torch.float32),
                TensorSpec((spec["batch"], spec["n"]), torch.bool))

    def in_shardings(self, cfg, shape: str, mesh):
        """The specs of (x, queries, masks): the corpus's rows and the
        masks' columns split over every mesh axis, queries replicated
        (``distributed.sharding.place`` cuts each rank's blocks)."""
        axes = tuple(mesh.axis_names)
        return (P(axes, None), P(), P(None, axes))

    def place_inputs(self, shape: str, mesh: Mesh, x, queries, masks):
        """The step's arguments on this rank from whole (x, queries,
        masks): the blocks ``place`` cuts by :meth:`in_shardings`, then the
        global index of the block's first row (0 on a rank outside the
        mesh, whose blocks are empty)."""
        blocks = place((x, queries, masks),
                       self.in_shardings(None, shape, mesh), mesh)
        return (*blocks, mesh.block_start(x.shape[0],
                                          tuple(mesh.axis_names)))

    def random_inputs(self, shape: str, seed: int = 0, reduced: bool = False,
                      density: float = 0.5, device: DeviceLike = "cuda"):
        """Whole (x, queries, masks) of a cell, drawn on ``device`` from a
        ``torch.Generator`` seeded with ``seed``: normal fp32 vectors and
        queries, masks passing each row with probability ``density``, drawn
        directly as bool a few queries at a time (a (B, n) fp32 draw at
        ``serve_25m`` would take 51.5 GB)."""
        spec = (REDUCED_ACORN_SHAPES if reduced else ACORN_SHAPES)[shape]
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        b, n, d = spec["batch"], spec["n"], spec["d"]
        x = torch.randn((n, d), generator=gen, device=dev)
        q = torch.randn((b, d), generator=gen, device=dev)
        masks = torch.empty((b, n), dtype=torch.bool, device=dev)
        for i in range(0, b, _MASK_BLOCK):
            rows = slice(i, min(i + _MASK_BLOCK, b))
            masks[rows] = torch.rand((rows.stop - i, n), generator=gen,
                                     device=dev) < density
        return x, q, masks


ARCH = AcornServeArch()
