"""The reference against hand-made cases and against the port's plain
path at tiny n."""
import numpy as np
import pytest
import torch

from chipbench import judge
from chipbench.reference import knn
from chipbench.reference.predicates import keyword_bits, mask_over

CPU = torch.device("cpu")

# six rows: label, date, keyword bitset (keywords 0, 1, 33 -> two words)
LABEL = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32)
DATE = torch.tensor([5, 10, 15, 20, 25, 30], dtype=torch.int32)
KW = torch.as_tensor(keyword_bits(np.array(
    [[0, -1], [1, -1], [33, -1], [0, 33], [-1, -1], [1, 0]]), 2))


def column(name):
    return {"label": LABEL, "date": DATE, "kw": KW}[name]


def mask(tree, b):
    return mask_over(tree, column, b, 6, CPU).tolist()


def T(*rows):
    return [[bool(v) for v in r] for r in rows]


def test_leaves():
    assert mask(("equals", "label", np.array([0, 2])), 2) == T(
        [1, 0, 0, 1, 0, 0], [0, 0, 1, 0, 0, 1])
    assert mask(("between", "date", np.array([10]), np.array([20])), 1) == T(
        [0, 1, 1, 1, 0, 0])
    assert mask(("contains_any", "kw", np.array([[33, -1], [1, 0]])), 2) == T(
        [0, 0, 1, 1, 0, 0], [1, 1, 0, 1, 0, 1])


def test_combinations():
    eq = ("equals", "label", np.array([0, 1]))
    bt = ("between", "date", np.array([0, 0]), np.array([12, 12]))
    assert mask(("and", [eq, bt]), 2) == T([1, 0, 0, 0, 0, 0],
                                           [0, 1, 0, 0, 0, 0])
    assert mask(("and", [eq, eq, bt]), 2) == mask(("and", [eq, bt]), 2)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -3.14159265])
    r = knn.round_to_tf32(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2.0**-10
    assert r[1] == 1.0 + 2.0**-10         # a tie goes away from zero
    assert abs(float(r[3]) + 3.14159265) < 2.0**-10 * 4
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)


def brute(xq, x, m, k):
    d = ((x.double()[None] - xq.double()[:, None]) ** 2).sum(-1)
    d = torch.where(m, d, torch.inf)
    v, i = torch.sort(d, dim=1, stable=True)
    return torch.where(torch.isinf(v[:, :k]), -1, i[:, :k]), v[:, :k]


@pytest.mark.parametrize("n,b,k", [(500, 7, 10), (37, 3, 10), (2000, 16, 5)])
def test_exact_knn_matches_brute_force(n, b, k, monkeypatch):
    monkeypatch.setattr(knn, "BLOCK_ELEMS", 64 * b)   # many row blocks
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, 8, generator=g)
    xq = torch.randn(b, 8, generator=g)
    m = torch.rand(b, n, generator=g) < 0.05           # few pass: -1 pads
    ans = knn.exact_knn(xq, x, lambda s, e: m[:, s:e], k)
    ids, d = brute(xq, x, m, k)
    assert torch.equal(ans.ids, ids)
    assert torch.allclose(ans.dists, d)
    assert torch.equal(ans.passing, m.sum(1))


def test_matches_the_ports_plain_path():
    """Masks against the port's compiled program, answers against its
    plain masked_topk, on an HCPS-like tiny table."""
    from repro_torch.core import (And, AttributeTable, Between, ContainsAny,
                                  evaluate_predicates, masked_topk)
    g = torch.Generator().manual_seed(3)
    n, b, k = 700, 12, 10
    x = torch.randn(n, 16, generator=g)
    xq = torch.randn(b, 16, generator=g)
    dates = torch.randint(0, 120, (n,), generator=g, dtype=torch.int32)
    kws = torch.randint(-1, 30, (n, 2), generator=g).numpy()
    bits = torch.as_tensor(keyword_bits(kws, 1))
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 100, b)
    qk = rng.integers(0, 30, (b, 2))
    tree = ("and", [("contains_any", "kw", qk),
                    ("between", "date", lo, lo + 20)])
    table = AttributeTable(int_cols={"date": dates},
                           bitset_cols={"kw": bits}, str_cols={},
                           n_keywords={"kw": 30})
    preds = [And((ContainsAny("kw", tuple(int(w) for w in qk[i])),
                  Between("date", int(lo[i]), int(lo[i] + 20))))
             for i in range(b)]
    port_mask = evaluate_predicates(preds, table)
    cols = {"date": dates, "kw": bits}
    m = mask_over(tree, cols.__getitem__, b, n, CPU)
    assert torch.equal(port_mask, m)
    ids, _ = masked_topk(xq, x, port_mask, k)
    ans = knn.exact_knn(xq, x, lambda s, e: m[:, s:e], k)
    assert torch.equal(ids.long(), ans.ids)


class _Corpus:
    def __init__(self, x, label):
        self.x, self.int_cols, self.bitset_cols = x, {"label": label}, {}

    @property
    def n(self):
        return self.x.shape[0]


def _case():
    g = torch.Generator().manual_seed(9)
    x = torch.randn(400, 8, generator=g)
    label = torch.randint(0, 3, (400,), generator=g, dtype=torch.int32)
    xq = torch.randn(6, 8, generator=g)
    vals = np.array([0, 1, 2, 0, 1, 2])
    tree = ("equals", "label", vals)
    m = label[None] == torch.as_tensor(vals)[:, None]
    exact = knn.exact_knn(xq, x, lambda s, e: m[:, s:e], 10)
    return _Corpus(x, label), xq, tree, exact


def _judge(corpus, xq, tree, exact, ids, d, route="prefilter"):
    t = judge.Tally()
    judge.judge_request(t, xq, tree, corpus, ids, d, [route] * 6, exact, 10)
    return t


def test_judge_reads_zero_on_the_exact_answer():
    corpus, xq, tree, exact = _case()
    t = _judge(corpus, xq, tree, exact, exact.ids, exact.dists.float())
    assert (t.violations, t.missing, t.recall) == (0, 0, 1.0)
    assert t.dist_gap < 1e-6 and t.rank_gap <= 0


def test_judge_catches_each_fault():
    corpus, xq, tree, exact = _case()
    ids, d = exact.ids.clone(), exact.dists.float().clone()
    bad = ids.clone()
    bad[0, 0] = int(torch.nonzero(corpus.int_cols["label"] != 0)[0])
    assert _judge(corpus, xq, tree, exact, bad, d).violations == 1
    dup = ids.clone()
    dup[1, 1] = dup[1, 0]
    assert _judge(corpus, xq, tree, exact, dup, d).violations == 1
    gone = ids.clone()
    gone[3:] = -1
    assert _judge(corpus, xq, tree, exact, gone, d).missing == 30
    off = d.clone()
    off[2, 4] *= 1.001
    assert _judge(corpus, xq, tree, exact, ids, off).dist_gap > 1e-4
    swapped = ids.clone()
    swapped[4, 9] = int(knn.exact_knn(
        xq[4:5], corpus.x, lambda s, e: (corpus.int_cols["label"][s:e] == 1
                                         )[None], 11).ids[0, 10])
    d2 = knn.sq_dists64(xq, corpus.x, swapped).float()
    t = _judge(corpus, xq, tree, exact, swapped, d2)
    assert t.rank_gap > 0 and t.recall < 1
    assert _judge(corpus, xq, tree, exact, swapped, d2, "graph").rank_gap == 0
