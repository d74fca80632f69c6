"""Bulk (batch-parallel) construction of ACORN-γ / ACORN-1 / HNSW indices.

Each level is built as one batch computation, on the device of ``x``:

  1. HNSW's exponential level assignment (§6.3.1 'Hierarchy'), or the
     caller's ``levels``.
  2. Per level, candidate edges = exact K nearest neighbors among the
     level's members (:func:`knn_among`, blocked distance matmuls).  ACORN's
     predicate-agnostic construction makes each level approximate a KNN
     graph (§6.3.1).
  3. ACORN-γ's predicate-agnostic compression on level 0 (Figure 5b):
     keep the M_β nearest candidates, then scan the tail keeping a
     candidate only if the 2-hop set H of previously kept candidates does
     not already cover it; stop when the stored list is full.
  4. For the HNSW baselines (post-filter and oracle partitions), the RNG
     heuristic pruning of Malkov & Yashunin (:func:`rng_prune`) instead.
  5. Reverse-edge slack slots (:func:`reverse_slack`).

The outputs are identical to the reference builder's on the same levels,
except where the exact KNN meets a near tie in distance (the two packages'
matmuls sum in different orders).  Block sizes differ from the
reference's, and the reverse-slack pass runs in torch on the device
instead of host numpy; neither changes a result.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bruteforce import masked_topk
from .graph import INVALID, LayeredGraph, assign_levels

Tensor = torch.Tensor

INF = float("inf")

# element budgets of one block of work (bounds peak memory)
_KNN_QBLOCK = 1024
_COMPRESS_ELEMS = 1 << 30
_SLACK_ELEMS = 1 << 28
_PRUNE_ELEMS = 1 << 29


# ---------------------------------------------------------------------------
# Exact KNN among a node subset (blocked)
# ---------------------------------------------------------------------------


def knn_among(x_members: Tensor, k: int, qblock: int = _KNN_QBLOCK) -> Tensor:
    """(m, d) -> (m, k) *local* indices of k nearest neighbors (self
    excluded); rows are padded with -1 when m-1 < k."""
    m = x_members.shape[0]
    kk = min(k + 1, m)
    dev = x_members.device
    outs = []
    for start in range(0, m, qblock):
        stop = min(start + qblock, m)
        ids, _ = masked_topk(x_members[start:stop], x_members, None, kk)
        self_ids = torch.arange(start, stop, dtype=torch.int32,
                                device=dev)[:, None]
        # stable packing: move self to the end, keep order otherwise
        order = torch.argsort((ids == self_ids).to(torch.int8), dim=1,
                              stable=True)
        ids = torch.gather(ids, 1, order)[:, :k]
        if ids.shape[1] < k:
            ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]),
                                          value=INVALID)
        outs.append(ids)
    if not outs:
        return torch.zeros((0, k), dtype=torch.int32, device=dev)
    return torch.cat(outs, dim=0)


# ---------------------------------------------------------------------------
# Reverse-edge slack
# ---------------------------------------------------------------------------
#
# A pure KNN edge set is directed: a node in nobody's KNN list is
# unreachable.  Forward lists are built to (cap - R) and the remaining R
# slots are filled with incoming edges, prioritized by the rank the source
# gave this node (rank 0 = "I am your nearest neighbor").


def reverse_slack(fwd: Tensor, r: int) -> Tensor:
    """(m, Kf) pruned forward lists -> (m, r) incoming-edge fill (-1 pad).

    Incoming edges of each target in order of (the source's rank of the
    target, source id) — the reference's ``np.lexsort((rank, dst))``."""
    m, k = fwd.shape
    dev = fwd.device
    src = torch.arange(m, dtype=torch.int64, device=dev).repeat_interleave(k)
    dst = fwd.reshape(-1).long()
    rank = torch.arange(k, dtype=torch.int64, device=dev).repeat(m)
    ok = dst >= 0
    src, dst, rank = src[ok], dst[ok], rank[ok]
    order = torch.argsort(dst * k + rank, stable=True)
    dst_s, src_s = dst[order], src[order]
    group_start = torch.searchsorted(dst_s, torch.arange(m, device=dev))
    pos = torch.arange(dst_s.shape[0], device=dev) - group_start[dst_s]
    keep = pos < r
    rev = torch.full((m, r), INVALID, dtype=torch.int32, device=dev)
    rev[dst_s[keep], pos[keep]] = src_s[keep].to(torch.int32)
    return rev


def with_reverse_slack(fwd: Tensor, r: int) -> Tensor:
    """Append r reverse-edge slack columns to pruned forward lists; slack
    entries already present in the forward list are blanked."""
    if r <= 0:
        return fwd
    rev = reverse_slack(fwd, r)
    m, k = fwd.shape
    step = max(1, _SLACK_ELEMS // max(r * k, 1))
    for s in range(0, m, step):
        sl = slice(s, min(s + step, m))
        dup = (rev[sl, :, None] == fwd[sl, None, :]).any(dim=2)
        rev[sl] = torch.where(dup, INVALID, rev[sl])
    return torch.cat([fwd, rev], dim=1)


# ---------------------------------------------------------------------------
# ACORN-γ predicate-agnostic compression (Figure 5b)
# ---------------------------------------------------------------------------


def _tail_membership(cand: Tensor, cand_lists: Tensor, m_beta: int,
                     t_hop: int) -> Tensor:
    """mem[b, i, j] = cand[b, m_beta + j] in N_T(cand[b, m_beta + i]) over
    the tail positions only (the scan never reads H elsewhere).

    Candidate lists hold each id once, so membership is a lookup: sort the
    block's candidates, ``searchsorted`` every 2-hop id into them, and mark
    the matches — O(K T log K) per node instead of O(K^2 T)."""
    bsz, kc = cand.shape
    kt = kc - m_beta
    tail = cand[:, m_beta:]
    valid = tail >= 0
    safe = tail.clamp(0, cand_lists.shape[0] - 1).long()
    hop2 = cand_lists[safe][:, :, :t_hop]                    # (B, Kt, T)
    hop2 = torch.where(valid[:, :, None], hop2, INVALID)
    srt, perm = torch.sort(tail, dim=1)
    flat = hop2.reshape(bsz, -1)
    at = torch.searchsorted(srt, flat).clamp(max=kt - 1)
    hit = (torch.gather(srt, 1, at) == flat) & (flat >= 0)
    j = torch.gather(perm, 1, at)                            # (B, Kt*T)
    i = torch.arange(kt, device=cand.device).repeat_interleave(hop2.shape[2])
    # hits mark cell (i, j); misses go to a spare last cell, so every
    # write stores True and duplicate targets cannot race
    cell = torch.where(hit, i[None, :] * kt + j, kt * kt)
    mem = torch.zeros((bsz, kt * kt + 1), dtype=torch.bool,
                      device=cand.device)
    mem.scatter_(1, cell, True)
    return mem[:, :kt * kt].reshape(bsz, kt, kt)


def _compress_block(cand: Tensor, cand_lists: Tensor, m_beta: int,
                    cap_out: int, t_hop: int) -> Tensor:
    """ACORN's pruning over a block of candidate lists.

    cand (B, K) sorted-by-distance local ids (-1 padded); cand_lists (m, K)
    every member's candidate list, whose first ``t_hop`` entries act as
    N(c) when folding into H.  Returns (B, cap_out) packed lists.

    The stored list is hard-bounded by ``cap_out`` (= M_β + O(M)); a tail
    candidate is pruned only when it appears in the first ``t_hop``
    (= M_β) entries of an already-kept tail candidate, and those entries
    are kept by every node's own compression, so the 2-hop recovery
    invariant holds exactly.
    """
    bsz, kc = cand.shape
    dev = cand.device
    valid = cand >= 0
    kept = valid & (torch.arange(kc, device=dev)[None, :] < m_beta)
    kept_cnt = kept.sum(dim=1, dtype=torch.int32)
    if kc > m_beta:
        mem = _tail_membership(cand, cand_lists, m_beta, t_hop)
        in_h = torch.zeros((bsz, kc - m_beta), dtype=torch.bool, device=dev)
        for jj in range(kc - m_beta):
            act = valid[:, m_beta + jj] & (kept_cnt < cap_out)
            keep_j = act & ~in_h[:, jj]
            in_h |= mem[:, jj] & keep_j[:, None]
            kept[:, m_beta + jj] = keep_j
            kept_cnt += keep_j.to(torch.int32)
    rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    scatter_to = torch.where(kept & (rank < cap_out), rank,
                             torch.full_like(rank, cap_out))
    out = torch.full((bsz, cap_out + 1), INVALID, dtype=torch.int32,
                     device=dev)
    out.scatter_(1, scatter_to, torch.where(kept, cand, INVALID))
    return out[:, :cap_out]


def acorn_compress(cand_lists: Tensor, m_beta: int, cap_out: int,
                   t_hop: int, block: Optional[int] = None) -> Tensor:
    """Compress all level-0 candidate lists; blocked over nodes."""
    m, kc = cand_lists.shape
    if block is None:
        kt = max(kc - m_beta, 1)
        block = max(1, _COMPRESS_ELEMS // (kt * max(kt, t_hop)))
    outs = [_compress_block(cand_lists[s:s + block], cand_lists, m_beta,
                            cap_out, t_hop)
            for s in range(0, m, block)]
    return torch.cat(outs, dim=0)


# ---------------------------------------------------------------------------
# RNG heuristic pruning (Malkov & Yashunin) — for the HNSW baselines
# ---------------------------------------------------------------------------


def _rng_prune_block(cand: Tensor, d_vc: Tensor, x_cand: Tensor,
                     m_out: int) -> Tensor:
    """cand (B, K) sorted ids, d_vc (B, K) dist(v, c), x_cand (B, K, d)
    vectors.  Keep c_j iff dist(v, c_j) < dist(c_j, c_k) for every
    previously kept c_k; at most ``m_out`` are kept, packed in order."""
    bsz, kc = cand.shape
    dev = cand.device
    # the reference's arithmetic: sum of squared differences over d
    diff = x_cand[:, :, None, :] - x_cand[:, None, :, :]
    d_cc = diff.square_().sum(dim=-1)  # (B, K, K)
    del diff
    valid = cand >= 0
    kept = torch.zeros((bsz, kc), dtype=torch.bool, device=dev)
    cnt = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    for j in range(kc):
        d_to_kept = torch.where(kept, d_cc[:, j, :], INF).amin(dim=1)
        keep_j = valid[:, j] & (cnt < m_out) & (d_vc[:, j] < d_to_kept)
        kept[:, j] = keep_j
        cnt += keep_j.to(torch.int32)
    rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    scatter_to = torch.where(kept & (rank < m_out), rank,
                             torch.full_like(rank, m_out))
    out = torch.full((bsz, m_out + 1), INVALID, dtype=torch.int32,
                     device=dev)
    out.scatter_(1, scatter_to, torch.where(kept, cand, INVALID))
    return out[:, :m_out]


def rng_prune(x_members: Tensor, cand: Tensor, m_out: int,
              block: Optional[int] = None) -> Tensor:
    """RNG-prune every member's sorted candidate list (local ids, -1
    padded) to at most ``m_out`` entries; blocked over members.  The
    output does not depend on ``block`` (default: a (block, K, K, d)
    difference tensor of at most ``_PRUNE_ELEMS`` elements)."""
    m, kc = cand.shape
    if block is None:
        block = max(1, _PRUNE_ELEMS // max(kc * kc * x_members.shape[1], 1))
    outs = []
    for start in range(0, m, block):
        cb = cand[start:start + block]
        ok = cb >= 0
        xc = torch.where(ok[:, :, None],
                         x_members[cb.clamp(0, m - 1).long()], 0.0)
        diff = xc - x_members[start:start + block][:, None, :]
        d_vc = torch.where(ok, (diff * diff).sum(dim=-1), INF)
        del diff
        outs.append(_rng_prune_block(cb, d_vc, xc, m_out))
    if not outs:
        return torch.zeros((0, m_out), dtype=torch.int32,
                           device=cand.device)
    return torch.cat(outs, dim=0)


# ---------------------------------------------------------------------------
# Top-level bulk builders
# ---------------------------------------------------------------------------


def build_bulk(
    x: Tensor,
    generator: Optional[torch.Generator],
    M: int,
    variant: str = "acorn-gamma",
    gamma: int = 1,
    m_beta: Optional[int] = None,
    efc: Optional[int] = None,
    t_hop: Optional[int] = None,
    max_level: Optional[int] = None,
    compress: bool = True,
    levels: Optional[np.ndarray] = None,
) -> LayeredGraph:
    """Build an index over ``x`` (n, d) on ``x``'s device.

    variant:
      'acorn-gamma' — candidate lists of size M·γ per level; level-0
                      compression with parameter M_β (paper §5.2).
      'acorn-1'     — γ=1, M_β=M: plain KNN lists (M per level, 2M at
                      level 0), no pruning (paper §5.3).
      'hnsw'        — ``efc`` candidates (default max(2M, 40)), RNG-pruned
                      into M (2M at level 0) less the reverse-edge slack;
                      used by the post-filter baseline and oracle
                      partitions.
    ``levels`` (n,) fixes the level assignment (the reference's own draw,
    for parity); otherwise ``generator`` draws it.
    """
    if variant not in ("acorn-gamma", "acorn-1", "hnsw"):
        raise ValueError(f"variant {variant!r}")
    n, _ = x.shape
    dev = x.device
    if variant == "acorn-1":
        gamma, m_beta = 1, M
    if m_beta is None:
        m_beta = 2 * M
    if efc is None:
        efc = max(2 * M, 40)
    if t_hop is None:
        # coverage may only be claimed through entries the covering node
        # provably retains after its own compression: its first M_β
        t_hop = min(M * gamma, m_beta)

    lv = assign_levels(generator, n, M, max_level=max_level, levels=levels)
    levels_np = lv.numpy()
    top = int(levels_np.max()) if n else 0
    lv_dev = lv.to(dev)

    neighbors, pos_arrays, node_id_arrays = [], [], []
    for lvl in range(top + 1):
        members = torch.nonzero(lv_dev >= lvl)[:, 0].to(torch.int32)
        m = int(members.shape[0])
        xm = x[members.long()]
        r_slack = max(2, M // 2)
        if variant == "hnsw":
            k_cand = min(efc, max(m - 1, 1))
            cap = 2 * M if lvl == 0 else M
        else:
            k_cand = min(M * gamma, max(m - 1, 1))
            cap = 2 * M if (lvl == 0 and variant == "acorn-1") else (
                M if variant == "acorn-1" else M * gamma)
        if m <= 1:
            local = torch.full((m, cap), INVALID, dtype=torch.int32,
                               device=dev)
        else:
            knn_local = knn_among(xm, k_cand)
            if variant == "hnsw":
                # RNG prune into cap - r slots; reverse edges fill the
                # rest, keeping HNSW's nominal M / 2M degree budget exact
                local = rng_prune(xm, knn_local, max(cap - r_slack, 1))
                local = with_reverse_slack(local, r_slack)
            elif variant == "acorn-gamma" and lvl == 0 and compress:
                cap0 = min(M * gamma, m_beta + 2 * M)
                local = acorn_compress(knn_local, min(m_beta, k_cand),
                                       cap_out=cap0,
                                       t_hop=min(t_hop, k_cand))
                local = with_reverse_slack(local, r_slack)
            else:
                local = with_reverse_slack(knn_local[:, :cap], r_slack)
        # local indices -> global ids
        glob = torch.where(local >= 0,
                           members[local.clamp(0, max(m - 1, 0)).long()],
                           INVALID)
        neighbors.append(glob.to(torch.int32))
        node_id_arrays.append(members)
        p = torch.full((n,), INVALID, dtype=torch.int32, device=dev)
        p[members.long()] = torch.arange(m, dtype=torch.int32, device=dev)
        pos_arrays.append(p)

    entry = int(np.argmax(levels_np))
    return LayeredGraph(
        neighbors=tuple(neighbors),
        pos=tuple(pos_arrays),
        node_ids=tuple(node_id_arrays),
        entry_point=torch.tensor(entry, dtype=torch.int32, device=dev),
        levels=lv_dev,
    )


def build_acorn_gamma(x, generator, M, gamma, m_beta=None, **kw
                      ) -> LayeredGraph:
    return build_bulk(x, generator, M, variant="acorn-gamma", gamma=gamma,
                      m_beta=m_beta, **kw)


def build_acorn_1(x, generator, M, **kw) -> LayeredGraph:
    return build_bulk(x, generator, M, variant="acorn-1", **kw)


def build_hnsw(x, generator, M, efc=None, **kw) -> LayeredGraph:
    return build_bulk(x, generator, M, variant="hnsw", efc=efc, **kw)
