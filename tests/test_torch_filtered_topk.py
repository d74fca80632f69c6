"""filtered_topk in the PyTorch port against the JAX reference.

The port's op (plain version on CPU tensors) is held against the
reference's op, which runs its Pallas kernel in interpret mode for
k <= 64 and its jnp oracle for k > 64, and the port's plain version
against the reference's oracle, on the same numpy inputs.  Tolerances: ids
identical; finite dists within atol 2e-3 (what the reference allows
between its own two routes: the kernel ranks on 2 q.x - |x|^2 and the
oracle on -(|q|^2 + |x|^2 - 2 q.x), which round differently); infinite
slots in the same places with the same sign, which pins the padding (+inf
on the kernel route, -inf for ip on the oracle route).  Every k <= n
(65 to 1,000, the reference's oracle route) and bf16 and fp16 corpora are
held to the reference with the tolerances their tests state.  The CUDA
kernel is held against the plain version on the card (skipped without
one), at k up to 256 (one launch) and above (select and sort), on fp32
and 16-bit corpora.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.filtered_topk.ops import filtered_topk as jax_op
from repro.kernels.filtered_topk.ref import filtered_topk_ref as jax_ref
from repro_torch.kernels.filtered_topk import (filtered_topk,
                                               filtered_topk_cuda,
                                               filtered_topk_ref)
from repro_torch.kernels.filtered_topk.kernel import KMAX
from torch_parity import (cuda_device,  # noqa: F401  (fixture)
                          load_chip_smoke)

# 16-bit corpora: the torch and jnp dtypes and the width of a near tie
# (the reference rounds x * x and its sum in the corpus dtype: one unit in
# the last place of |q|^2 + |x|^2)
HALF = {"bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7),
        "fp16": (torch.float16, jnp.float16, 2.0 ** -10)}


def _inputs(b, n, d, p=0.5, seed=0, dup=False, empty_rows=False,
            ints=False, period=None, tail=None, few=None, last_row=False):
    rng = np.random.default_rng(seed)
    if ints:  # small integers: both versions score exactly
        q = rng.integers(-64, 65, size=(b, d)).astype(np.float32)
        x = rng.integers(-64, 65, size=(n, d)).astype(np.float32)
    else:
        q = rng.normal(size=(b, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
    if dup:   # blocks of identical rows: the tie order decides
        x = x[np.arange(n) // 7]
    mask = rng.random((b, n)) < p
    if empty_rows:
        mask[0, :] = False                      # nothing passes
        if b > 1:
            mask[1, :] = False
            mask[1, n - n // 8:] = True         # only the last rows pass
    if period:   # x repeats every `period` rows: every tile scores the same
        x = x[np.arange(n) % period]
    if tail:     # nothing passes before the last `tail` rows
        mask[:, :n - tail] = False
    if few:      # exactly `few` rows pass per query, anywhere
        mask[:] = False
        for row in mask:
            row[rng.choice(n, few, replace=False)] = True
    if last_row:
        mask[:, -1] = True
    return q, x, mask


def _assert_same(ids, dists, want_ids, want_dists):
    ids, dists = np.asarray(ids), np.asarray(dists)
    want_ids, want_dists = np.asarray(want_ids), np.asarray(want_dists)
    np.testing.assert_array_equal(ids, want_ids)
    inf = np.isinf(want_dists)
    np.testing.assert_array_equal(np.isinf(dists), inf)
    np.testing.assert_array_equal(np.sign(dists[inf]), np.sign(want_dists[inf]))
    np.testing.assert_allclose(dists[~inf], want_dists[~inf], atol=2e-3)


CASES = {
    # the shapes of the reference's own kernel tests
    "1x100d8k5": dict(b=1, n=100, d=8, k=5),
    "4x513d32k10": dict(b=4, n=513, d=32, k=10),
    "9x1024d128k16": dict(b=9, n=1024, d=128, k=16),
    "130x300d16k3": dict(b=130, n=300, d=16, k=3),
    "all_pass_3x257k7": dict(b=3, n=257, d=16, k=7, p=1.1),
    "padded_5x777d24k9": dict(b=5, n=777, d=24, k=9, p=0.2, empty_rows=True),
    # retrieval_cand at the reduced config: k = 100 > 64, the oracle route
    "retrieval_1x256d16k100": dict(b=1, n=256, d=16, k=100),
    "sparse_3x256d16k100": dict(b=3, n=256, d=16, k=100, p=0.2,
                                empty_rows=True),
    "dup_4x300d8k9": dict(b=4, n=300, d=8, k=9, dup=True),
    "dup_4x300d8k100": dict(b=4, n=300, d=8, k=100, dup=True),
    # the drawing options of the card's edge cases, at small sizes
    "period_2x640d4k40": dict(b=2, n=640, d=4, k=40, p=1.1, ints=True,
                              period=64),
    "tail_3x500d8k20": dict(b=3, n=500, d=8, k=20, tail=70),
    "few_2x900d8k50": dict(b=2, n=900, d=8, k=50, few=7),
    "last_row_2x129d8k9": dict(b=2, n=129, d=8, k=9, p=0.1, last_row=True),
}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_reference(case, metric):
    kw = dict(CASES[case])
    k = kw.pop("k")
    q, x, mask = _inputs(**kw, seed=len(case))
    jq, jx, jm = jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask)
    tq, tx, tm = (torch.from_numpy(a) for a in (q, x, mask))
    # the op: Pallas kernel (interpret mode) for k <= 64, oracle above
    want = jax_op(jq, jx, jm, k, metric, use_kernel=True, interpret=True)
    _assert_same(*filtered_topk(tq, tx, tm, k, metric), *want)
    # the plain versions
    _assert_same(*filtered_topk_ref(tq, tx, tm, k, metric),
                 *jax_ref(jq, jx, jm, k, metric))


@pytest.mark.parametrize("k,sign", [(64, 1.0), (65, -1.0)])
def test_ip_padding_sign_follows_the_reference_route(k, sign):
    """ip pads with +inf up to k = 64 and -inf above, as the reference's
    op does (its kernel route vs its oracle route)."""
    q, x, mask = _inputs(2, 100, 8, p=0.3)
    ids, dists = filtered_topk(*(torch.from_numpy(a) for a in (q, x, mask)),
                               k, "ip")
    pad = ids.numpy() < 0
    assert pad.any()
    assert (dists.numpy()[pad] == sign * np.inf).all()


def _scale(q, x, ids, metric):
    """Per slot, the scale of a dist's rounding: |q|^2 + |x|^2 for l2,
    |q| |x| for ip (x the slot's row; row 0 at padding)."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    qn = (q64 ** 2).sum(1)[:, None]
    xn = (x64[np.clip(ids, 0, None)] ** 2).sum(-1)
    return qn + xn if metric == "l2" else np.sqrt(qn * xn)


def _near_ties(ids, want_ids, q, x, metric, width):
    """The (query, slot) pairs whose ids differ, each checked to be a near
    tie: the two rows' scores, in float64 from the values both sides
    read, within ``width`` of the scale."""
    ties = []
    for qi, j in zip(*np.nonzero(ids != want_ids)):
        a, b = int(ids[qi, j]), int(want_ids[qi, j])
        assert a >= 0 and b >= 0, (qi, j, a, b)
        qv = q[qi].astype(np.float64)
        xa, xb = x[a].astype(np.float64), x[b].astype(np.float64)
        if metric == "l2":
            sa, sb = ((xa - qv) ** 2).sum(), ((xb - qv) ** 2).sum()
            scale = qv @ qv + max(xa @ xa, xb @ xb)
        else:
            sa, sb = xa @ qv, xb @ qv
            scale = np.sqrt(qv @ qv * max(xa @ xa, xb @ xb))
        assert abs(sa - sb) <= width * scale, (qi, j, a, b, sa, sb)
        ties.append((int(qi), int(j)))
    return ties


def _assert_close(ids, dists, want_ids, want_dists, q, x, metric, rel,
                  ties=()):
    """Ids equal but at the named near-tie slots ``ties`` (each a near tie
    within ``rel`` of its scale), padding identical, finite dists within
    ``rel`` of their scale."""
    ids, dists = np.asarray(ids), np.asarray(dists, np.float64)
    want_ids = np.asarray(want_ids)
    want_dists = np.asarray(want_dists, np.float64)
    assert _near_ties(ids, want_ids, q, x, metric, rel) == list(ties)
    inf = np.isinf(want_dists)
    np.testing.assert_array_equal(np.isinf(dists), inf)
    np.testing.assert_array_equal(np.sign(dists[inf]),
                                  np.sign(want_dists[inf]))
    gap = np.abs(dists[~inf] - want_dists[~inf])
    assert (gap <= rel * _scale(q, x, want_ids, metric)[~inf]).all(), \
        gap.max()


# k past the one-launch kernel's 256 and past the reference's kernel route
# (64): (k, n); the near-tie slots of each (k, metric), named: fp32 scores
# of two rows within 1e-5 of their scale, ordered differently by the two
# packages' fp32 sums
LARGE_K = [(65, 2000), (257, 3000), (300, 5000), (1000, 3000)]
LARGE_K_TIES = {(1000, "l2"): [(1, 800), (1, 801)]}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k,n", LARGE_K)
def test_large_k_matches_reference(k, n, metric):
    """Any k <= n: the port's op against the reference's (its oracle route
    for k > 64): ids equal but at the named near ties, dists within 1e-5
    of their scale, slots past the passing rows padded with id -1 and
    +inf (l2) or -inf (ip) in both."""
    q, x, mask = _inputs(4, n, 16, p=0.3, seed=k)
    got = filtered_topk(*(torch.from_numpy(a) for a in (q, x, mask)), k,
                        metric)
    want = jax_op(jnp.asarray(q), jnp.asarray(x), jnp.asarray(mask), k,
                  metric, use_kernel=True, interpret=True)
    _assert_close(*got, *want, q, x, metric, 1e-5,
                  LARGE_K_TIES.get((k, metric), ()))
    if k > mask.sum(1).min():
        pad = np.asarray(want[0]) < 0
        assert pad.any()
        sign = 1.0 if metric == "l2" else -1.0
        assert (got[1].numpy()[pad] == sign * np.inf).all()


# each (corpus dtype, metric)'s near-tie slots at k = 10 against the
# reference on the 16-bit corpus itself, named (query, slot): the
# reference's |x|^2 is rounded in 16 bits, the port's is exact in fp32
HALF_TIES = {
    ("bf16", "l2"): [(1, 3), (1, 4), (4, 6), (4, 7), (5, 5), (5, 6)],
    ("fp16", "l2"): [(0, 9), (5, 5), (5, 6)],
    ("bf16", "ip"): [], ("fp16", "ip"): [],
}


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("half", sorted(HALF))
def test_16bit_corpus_matches_reference(half, metric):
    """A bf16 or fp16 corpus (fp32 queries): the port widens the stored
    values and scores in fp32.  Against the reference on the widened
    corpus (the same values): ids equal, dists within 1e-5 of their scale,
    at k = 10 (its kernel route, interpret mode) and k = 100 (its oracle
    route).  Against the reference on the 16-bit corpus itself, at k = 10:
    dists within one unit in the last place of the corpus dtype times
    |q|^2 + |x|^2, ids equal but at the named near ties of that width."""
    tdt, jdt, width = HALF[half]
    q, x, mask = _inputs(6, 3000, 32, p=0.5, seed=5)
    x16 = torch.from_numpy(x).to(tdt)
    xw = x16.float().numpy()
    jq, jm = jnp.asarray(q), jnp.asarray(mask)
    for k in (10, 100):
        got = filtered_topk(torch.from_numpy(q), x16, torch.from_numpy(mask),
                            k, metric)
        assert got[1].dtype == torch.float32
        want = jax_op(jq, jnp.asarray(xw), jm, k, metric, use_kernel=True,
                      interpret=True)
        _assert_close(*got, *want, q, xw, metric, 1e-5)
    want = jax_op(jq, jnp.asarray(xw).astype(jdt), jm, 10, metric,
                  use_kernel=True, interpret=True)
    got = filtered_topk(torch.from_numpy(q), x16, torch.from_numpy(mask), 10,
                        metric)
    _assert_close(*got, *want, q, xw, metric, width, HALF_TIES[half, metric])


def test_16bit_queries_are_widened():
    """q may be 16-bit too: the op equals its call on q widened to fp32."""
    q, x, mask = (torch.from_numpy(a) for a in _inputs(3, 500, 16))
    for tdt, _, _ in HALF.values():
        for metric in ("l2", "ip"):
            got = filtered_topk(q.to(tdt), x.to(tdt), mask, 300, metric)
            want = filtered_topk(q.to(tdt).float(), x.to(tdt).float(), mask,
                                 300, metric)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_k_above_n_raises():
    q, x, mask = (torch.from_numpy(a) for a in _inputs(2, 10, 4))
    for fn in (filtered_topk, filtered_topk_ref):
        with pytest.raises(ValueError, match="k = 11 > n = 10"):
            fn(q, x, mask, 11, "l2")


def test_cpu_tensors_route_to_plain_version():
    q, x, mask = (torch.from_numpy(a) for a in _inputs(3, 200, 8))
    before = filtered_topk_cuda.launches
    ids, dists = filtered_topk(q, x, mask, 9, "l2")
    rids, rd = filtered_topk_ref(q, x, mask, 9, "l2")
    assert torch.equal(ids, rids) and torch.equal(dists, rd)
    assert filtered_topk_cuda.launches == before


def test_launcher_state_is_zeroed_once_per_stream_and_grows():
    """The kernel's per-query state (threshold, arrival count) is one zeroed
    buffer per (device, stream), replaced by a larger zeroed one when a
    call has more queries; the kernel leaves it zero after each call."""
    from repro_torch.kernels.filtered_topk import kernel
    dev = torch.device("cpu")
    st = kernel._state(3, dev, 12345)
    assert st.dtype == torch.int64 and st.numel() == 6
    assert not st.any()
    assert kernel._state(2, dev, 12345) is st
    big = kernel._state(5, dev, 12345)
    assert big.numel() == 10 and not big.any() and big is not st
    assert kernel._state(1, dev, 54321) is not big
    for key in [(None, 12345), (None, 54321)]:
        kernel._STATE.pop(key)


# the same as TOPK_EDGE_CASES in chip_smoke.py, which runs them on the card;
# the kernel's tiles hold 2048 rows
CARD_CASES = [
    dict(b=5, n=777, d=24, k=9, p=0.2, empty_rows=True),
    dict(b=3, n=20_000, d=13, k=100, p=0.3, empty_rows=True),  # scalar loads
    dict(b=2, n=40_000, d=64, k=KMAX, p=0.05),    # several tiles, k at cap
    dict(b=4, n=9_000, d=16, k=33, dup=True),
    dict(b=1, n=70_000, d=8, k=1, p=1.1),
    dict(b=2, n=100, d=8, k=100, p=0.3),          # k = n, one tile
    dict(b=1, n=64, d=3, k=64, p=1.1, dup=True),  # k = n = the least tile
    # 512, 2442 and 16,602 tile lists; integer data, exact ties
    dict(b=2, n=1 << 20, d=4, k=KMAX, ints=True),
    dict(b=3, n=5_000_000, d=4, k=128, ints=True),
    dict(b=1, n=34_000_000, d=4, k=KMAX, ints=True),
    # every tile holds the same scores: every key ties with the threshold
    # and the id order decides; the last CTA's candidates overflow its
    # shared buffer
    dict(b=2, n=64 * 2048, d=4, k=KMAX, p=1.1, ints=True, period=2048),
    dict(b=1, n=1 << 20, d=8, k=KMAX, p=1.1, ints=True),  # all pass
    dict(b=2, n=5 * 2048 + 300, d=16, k=100, tail=300),  # last tile only
    dict(b=2, n=1 << 20, d=32, k=100, few=37),    # fewer than k, spread
    dict(b=2, n=4 * 2048 + 1, d=16, k=50, p=0.3, last_row=True),
]


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("ci", range(len(CARD_CASES)))
def test_cuda_kernel_matches_plain_version(cuda_device, ci, metric):
    kw = dict(CARD_CASES[ci])
    k = kw.pop("k")
    q, x, mask = (torch.from_numpy(a).to(cuda_device)
                  for a in _inputs(**kw, seed=ci))
    ids, dists = filtered_topk_cuda(q, x, mask, k, metric)
    want_ids, want_dists = filtered_topk_ref(q, x, mask, k, metric)
    torch.cuda.synchronize()
    _assert_same(ids.cpu(), dists.cpu(), want_ids.cpu(), want_dists.cpu())


# k past KMAX (the select-and-sort path), the same as TOPK_LARGE_K_CASES in
# chip_smoke.py (case i is drawn with seed i): the timed shape at three k,
# k = n with fewer passing rows (padding), more kept keys than the 16,384 a
# CTA sorts in shared memory (merged in global memory), integer data whose
# ties the id order decides, scalar loads (d = 13) and a bf16 corpus
CARD_LARGE_K = [
    dict(b=64, n=131_072, d=128, k=257),
    dict(b=64, n=131_072, d=128, k=1024),
    dict(b=64, n=131_072, d=128, k=4096),
    dict(b=3, n=5000, d=16, k=5000, p=0.3),
    dict(b=3, n=50_000, d=16, k=20_000, p=0.8),
    dict(b=2, n=45_000, d=4, k=40_000, p=1.1, ints=True),
    dict(b=2, n=64 * 2048, d=4, k=2048, p=1.1, ints=True, period=2048),
    dict(b=2, n=20_000, d=13, k=500, p=0.3),
    dict(b=2, n=2100, d=24, k=2000, half="bf16"),
]


def _card_inputs(case, seed, dev):
    kw = dict(case)
    k = kw.pop("k")
    half = kw.pop("half", None)
    q, x, mask = (torch.from_numpy(a).to(dev)
                  for a in _inputs(**kw, seed=seed))
    return q, x if half is None else x.to(HALF[half][0]), mask, k


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("ci", range(len(CARD_LARGE_K)))
def test_cuda_kernel_takes_k_above_cap(cuda_device, ci, metric):
    q, x, mask, k = _card_inputs(CARD_LARGE_K[ci], ci, cuda_device)
    assert k > KMAX
    ids, dists = filtered_topk_cuda(q, x, mask, k, metric)
    want_ids, want_dists = filtered_topk_ref(q, x, mask, k, metric)
    torch.cuda.synchronize()
    _assert_same(ids.cpu(), dists.cpu(), want_ids.cpu(), want_dists.cpu())


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("ci", range(len(CARD_CASES)))
def test_cuda_kernel_16bit_matches_plain_version(cuda_device, ci, half,
                                                 metric):
    q, x, mask, k = _card_inputs(dict(CARD_CASES[ci], half=half), ci,
                                 cuda_device)
    for qq in (q, q.to(HALF[half][0])):
        ids, dists = filtered_topk_cuda(qq, x, mask, k, metric)
        want_ids, want_dists = filtered_topk_ref(qq, x, mask, k, metric)
        torch.cuda.synchronize()
        _assert_same(ids.cpu(), dists.cpu(), want_ids.cpu(),
                     want_dists.cpu())


@pytest.mark.parametrize("which", ["edge", "large_k"])
def test_chip_smoke_draws_the_card_cases(which):
    """chip_smoke.py holds the kernel to the plain version at the same
    cases as this file's card tests, drawn from the same seeds (the draws
    compared where n <= 2^20)."""
    smoke = load_chip_smoke()
    mine, theirs = {"edge": (CARD_CASES, smoke.TOPK_EDGE_CASES),
                    "large_k": (CARD_LARGE_K, smoke.TOPK_LARGE_K_CASES)}[which]
    assert theirs == mine
    assert smoke.HALF_DTYPES == {h: str(t).split(".")[-1]
                                 for h, (t, _, _) in HALF.items()}
    for ci, case in enumerate(mine):
        if case["n"] > 1 << 20:
            continue
        kw = {k: v for k, v in case.items() if k not in ("k", "half")}
        for got, want in zip(smoke.topk_inputs(**kw, seed=ci),
                             _inputs(**kw, seed=ci)):
            np.testing.assert_array_equal(got, want)
