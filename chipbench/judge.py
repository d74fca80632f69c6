"""The comparison that decides ``correct``.

The program's answers to a request (ids and distances, (B, k)) are held
to the reference's exact answer (``reference.knn.exact_knn``) and to the
request's predicates as the reference evaluates them.  Five numbers, each
summed, maximised or averaged over every compared query:

* ``violations``: returned ids that are out of range, repeated within a
  query, or whose row fails the query's predicate (a guarantee: limit 0);
* ``missing``: slots left empty (-1) while the query has that many
  passing rows;
* ``dist_gap``: the largest gap between a returned distance and the
  squared L2 of the returned row recomputed in float64, over the query's
  exact k-th distance;
* ``rank_gap``: over queries the program routed to its exact pre-filter,
  the largest gap between the j-th best returned distance (recomputed)
  and the exact j-th distance, over the exact k-th distance;
* ``recall_miss``: one less the mean recall@k over queries with a
  passing row: the share of the exact answers the search did not find.
  It holds an approximate route's search to the exact answer, where a
  stunted traversal returns passing rows at their true distances and
  reads sound by the numbers above.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from chipbench.reference import knn
from chipbench.reference.predicates import evaluate

Tensor = torch.Tensor

NUMBERS = ("violations", "missing", "dist_gap", "rank_gap", "recall_miss")


@dataclass
class Tally:
    """Running totals of the compared numbers over checked requests."""

    violations: int = 0
    missing: int = 0
    dist_gap: float = 0.0
    rank_gap: float = 0.0
    queries: int = 0
    requests: int = 0
    recall_sum: float = 0.0
    recall_n: int = 0

    @property
    def recall(self) -> Optional[float]:
        return self.recall_sum / self.recall_n if self.recall_n else None

    @property
    def recall_miss(self) -> float:
        return 1.0 - self.recall if self.recall_n else 0.0

    def numbers(self) -> Dict[str, float]:
        return {name: getattr(self, name) for name in NUMBERS}


def verdict(tally: Tally, limits: Dict[str, float], failed: int):
    """(correct, [(name, value, limit)]) for every number ``limits`` names."""
    rows = [(name, tally.numbers()[name], float(limits[name]))
            for name in NUMBERS if name in limits]
    ok = (failed == 0 and tally.requests > 0
          and all(v <= lim for _, v, lim in rows))
    return ok, rows


def returned_pass(tree, corpus, ids: Tensor) -> Tensor:
    """(B, k) bool: the row each returned id names passes its query's
    predicate (False for ids out of range)."""
    n = corpus.n
    safe = ids.clamp(0, n - 1)

    def column(name):
        if name in corpus.int_cols:
            return corpus.int_cols[name][safe]
        return corpus.bitset_cols[name][safe]

    m = evaluate(tree, column, ids.shape[0], ids.device)
    ok = (ids >= 0) & (ids < n)
    return m & ok


def judge_request(tally: Tally, xq: Tensor, tree, corpus, ids: Tensor,
                  dists: Tensor, routes: np.ndarray, exact: knn.Answer,
                  k: int) -> None:
    """Add one request's comparison to ``tally``.  ``ids`` / ``dists`` are
    the answers judged (the program's, or the control's)."""
    b = ids.shape[0]
    ids = ids.to(torch.int64)
    valid = ids != -1
    # violations: out of range, failing, or repeated
    passes = returned_pass(tree, corpus, ids)
    srt, _ = torch.sort(torch.where(valid, ids, -2 - torch.arange(
        ids.shape[1], device=ids.device)[None]), dim=1)
    dup = torch.zeros_like(valid)
    dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
    tally.violations += int((valid & ~passes).sum()) + int(dup.sum())

    want = torch.clamp(exact.passing, max=k)
    got = valid.sum(dim=1)
    tally.missing += int(torch.clamp(want - got, min=0).sum())

    has = want > 0
    kth = exact.dists.gather(1, (want - 1).clamp(min=0)[:, None])[:, 0]
    scale = torch.where(has, kth, torch.ones_like(kth)).clamp(min=1e-12)
    d_true = knn.sq_dists64(xq, corpus.x, torch.where(passes, ids, -1))
    ret = dists.double()
    gap = torch.where(valid & passes, (ret - d_true).abs() / scale[:, None],
                      torch.zeros_like(ret))
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")),
                      gap)
    tally.dist_gap = max(tally.dist_gap, float(gap.max()) if b else 0.0)

    exact_rows = torch.as_tensor(np.asarray(routes) == "prefilter",
                                 device=ids.device)
    if bool(exact_rows.any()):
        mine, _ = torch.sort(d_true, dim=1)
        slots = torch.arange(k, device=ids.device)[None] < want[:, None]
        rg = torch.where(slots & exact_rows[:, None],
                         (mine - exact.dists) / scale[:, None],
                         torch.full_like(mine, float("-inf")))
        tally.rank_gap = max(tally.rank_gap, float(rg.max()))

    hit = ((ids[:, :, None] == exact.ids[:, None, :])
           & (exact.ids[:, None, :] >= 0)).any(dim=1).sum(dim=1)
    rec = hit[has].double() / want[has].double()
    tally.recall_sum += float(rec.sum())
    tally.recall_n += int(has.sum())
    tally.queries += b
    tally.requests += 1
