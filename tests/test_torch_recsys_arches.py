"""DIEN, SASRec and DCN-v2 of the port against the JAX reference, at the
REDUCED configs: twins of ``test_recsys_train_step``,
``test_recsys_serve_step`` and ``test_recsys_retrieval_cand`` of
``tests/test_models_smoke.py``; the reference's parameters carried across
(``convert.{dien,sasrec,dcnv2}_params_from_arrays``) for forward, loss,
gradients, one AdamW step continued from a reference state, serve and
both retrieval variants; the blocked pieces (``GRUScan``,
``SampledLogits``, chunked ``dien_score_candidates``) against their plain
versions; the reference's indexing quirks; ``mlp``, ``layer_norm`` and
``swiglu``.

Tolerances: logits, scores and losses within rtol 1e-5 (fp32; atol 1e-6
where a value may be near 0); gradients within rtol 1e-4 and atol 1e-6,
the atol times the gradient's largest magnitude where that exceeds 1
(``torch_parity.assert_grad_close``); parameters and moments after one
``adamw_update`` from the reference's own gradients within rtol 1e-6 and
1e-6 of each tensor's largest magnitude.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import common as jcommon
from repro.models import recsys as jrecsys
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.convert import param_arrays
from repro_torch.models import common
from repro_torch.models import recsys
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import AdamWState, adamw_update, init_adamw
from torch_parity import (assert_grad_close, one_thread,  # noqa: F401
                          port_adamw_state, port_recsys)

pytestmark = pytest.mark.usefixtures("one_thread")

KEY = jax.random.PRNGKey(0)
ARCHES = ["dien", "sasrec", "dcn-v2"]
RTOL = dict(rtol=1e-5, atol=1e-6)


def _materialize(batch_specs, seed, int_hi):
    """Random tensors for a batch of ``TensorSpec``: integers in
    [0, int_hi), masks ones, the rest normal (the reference smoke test's
    law)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in batch_specs.items():
        if not spec.dtype.is_floating_point:
            a = rng.integers(0, int_hi, spec.shape)
        elif "mask" in name:
            a = np.ones(spec.shape)
        else:
            a = rng.normal(size=spec.shape)
        out[name] = torch.as_tensor(np.asarray(a)).to(spec.dtype)
    return out


def _batch(arch_id, cfg, b, seed, kind="train"):
    """A numpy batch with padding: DIEN histories of random length (prefix
    mask, -1 beyond), SASRec sequences left-padded with -1 (``pos`` the
    next item), DCN-v2's dense features ``log1p`` of exponentials and
    ids uniform over each vocabulary."""
    rng = np.random.default_rng(seed)
    if arch_id == "dien":
        s = cfg.seq_len
        lens = rng.integers(1, s + 1, size=b)
        m = np.arange(s)[None] < lens[:, None]
        out = {"hist_items": np.where(m, rng.integers(0, cfg.n_items, (b, s)),
                                      -1),
               "hist_cates": np.where(m, rng.integers(0, cfg.n_cates, (b, s)),
                                      -1),
               "mask": m.astype(np.float32),
               "target_item": rng.integers(0, cfg.n_items, b),
               "target_cate": rng.integers(0, cfg.n_cates, b),
               "label": (rng.random(b) < 0.5).astype(np.float32)}
    elif arch_id == "sasrec":
        s = cfg.seq_len
        lens = rng.integers(2, s + 1, size=b)
        items = rng.integers(0, cfg.n_items, (b, s + 1))
        real = np.arange(s)[None] >= (s - lens[:, None])
        out = {"seq": np.where(real, items[:, :-1], -1),
               "pos": np.where(real, items[:, 1:], -1)}
        if kind == "train":
            out["neg"] = rng.integers(0, cfg.n_items, (b, s, 64))
        else:
            out["target"] = rng.integers(0, cfg.n_items, b)
    else:
        out = {"dense": np.log1p(rng.exponential(size=(b, cfg.n_dense))
                                 ).astype(np.float32),
               "sparse": np.stack([rng.integers(0, v, b)
                                   for v in cfg.vocab_sizes], axis=1),
               "label": (rng.random(b) < 0.25).astype(np.float32)}
    if kind != "train":
        out.pop("label", None)
        out.pop("pos", None)
    return {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
            for k, v in out.items()}


def _pair(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch_id):
    jarch, arch = jax_get_arch(arch_id), get_arch(arch_id)
    jcfg, cfg = jarch.config(reduced=True), arch.config(reduced=True)
    jparams = jarch.init(jcfg, KEY)
    return jarch, arch, jcfg, cfg, jparams, port_recsys(jparams, cfg)


_JLOSS = {"dien": jrecsys.dien_loss, "sasrec": jrecsys.sasrec_loss,
          "dcn-v2": jrecsys.dcnv2_loss}
_JFWD = {"dien": lambda c, p, b: jrecsys.dien_forward(c, p, b),
         "sasrec": lambda c, p, b: jrecsys.sasrec_forward(c, p, b["seq"]),
         "dcn-v2": lambda c, p, b: jrecsys.dcnv2_forward(c, p, b)}
_FWD = {"dien": lambda c, m, b: recsys.dien_forward(c, m, b),
        "sasrec": lambda c, m, b: recsys.sasrec_forward(c, m, b["seq"]),
        "dcn-v2": lambda c, m, b: recsys.dcnv2_forward(c, m, b)}


def _jgrad(arch_id, jcfg):
    """The reference loss's value and gradients, jitted (one compile is
    cheaper than the scans' op-by-op dispatch)."""
    return jax.jit(jax.value_and_grad(functools.partial(_JLOSS[arch_id],
                                                        jcfg)))


# ---------------------------------------------------------------------------
# twins of tests/test_models_smoke.py's recsys tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHES)
def test_recsys_train_step(arch_id):
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = init_adamw(model)
    _, _, batch_s = arch.abstract_inputs(cfg, "train_batch", reduced=True)
    batch = _materialize(batch_s, seed=0, int_hi=4)
    before = {k: p.clone() for k, p in model.named_parameters()}
    model2, opt2, loss = arch.step_fn(cfg, "train_batch")(model, opt, batch)
    assert model2 is model and np.isfinite(float(loss)), f"{arch_id} {loss}"
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert int(opt2.step) == 1
    assert any(not torch.equal(p, before[k])
               for k, p in model.named_parameters())
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch_id", ARCHES)
def test_recsys_serve_step(arch_id):
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, batch_s = arch.abstract_inputs(cfg, "serve_p99", reduced=True)
    out = arch.step_fn(cfg, "serve_p99")(model,
                                         _materialize(batch_s, 0, 4))
    assert out.shape == (8,) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("arch_id,optimized", [
    ("dien", False), ("sasrec", False), ("dcn-v2", False), ("dcn-v2", True)])
def test_recsys_retrieval_cand(arch_id, optimized):
    arch = get_arch(arch_id)
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ins = arch.abstract_inputs(cfg, "retrieval_cand", reduced=True)
    batch = _materialize(ins[1], 0, 4)
    cands = [_materialize({"c": s}, i + 1, 4)["c"]
             for i, s in enumerate(ins[2:])]
    kw = dict(optimized=True) if optimized else {}
    out = arch.step_fn(cfg, "retrieval_cand", reduced=True, **kw)(
        model, batch, *cands)
    assert out.shape == (256,) and bool(torch.isfinite(out).all())


def _specs(tree):
    """{name: (shape, dtype name)} of a batch struct (either package)."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch_id", ARCHES)
def test_cells_configs_and_inputs_match_reference(arch_id):
    jarch, arch = jax_get_arch(arch_id), get_arch(arch_id)
    assert [(c.shape, c.kind) for c in arch.cells()] == [
        (c.shape, c.kind) for c in jarch.cells()]
    for reduced in (False, True):
        mine = dataclasses.asdict(arch.config(reduced=reduced))
        ref = dataclasses.asdict(jarch.config(reduced=reduced))
        assert {k: v for k, v in mine.items() if k != "dtype"} == {
            k: v for k, v in ref.items() if k != "dtype"}
    cfg, jcfg = arch.config(reduced=True), jarch.config(reduced=True)
    for shape in ("train_batch", "serve_p99", "serve_bulk",
                  "retrieval_cand"):
        mine = arch.abstract_inputs(cfg, shape, reduced=True)
        ref = jarch.abstract_inputs(jcfg, shape, reduced=True)
        want = param_arrays(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), ref[0]),
            arch.module(cfg))
        assert {k: v.shape for k, v in want.items()} == {
            k: s.shape for k, s in mine[0].items()}
        i = 2 if shape == "train_batch" else 1
        assert _specs(mine[i]) == _specs(ref[i])
        assert [tuple(s.shape) for s in mine[i + 1:]] == [
            tuple(s.shape) for s in ref[i + 1:]]


# ---------------------------------------------------------------------------
# forward, loss, gradients, AdamW against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHES)
def test_forward_loss_and_grads_match_reference(arch_id):
    jarch, arch, jcfg, cfg, jparams, model = _setup(arch_id)
    jb, tb = _pair(_batch(arch_id, cfg, 32, seed=1))
    np.testing.assert_allclose(
        _FWD[arch_id](cfg, model, tb).numpy(),
        np.asarray(_JFWD[arch_id](jcfg, jparams, jb)), **RTOL)
    jl, jg = _jgrad(arch_id, jcfg)(jparams, jb)
    loss, grads = value_and_grad(arch.loss_fn(cfg, "train_batch"), model, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = param_arrays(_np(jg), model)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        assert_grad_close(g.numpy(), want[k], rtol=1e-4, what=k)


def _assert_close_to_scale(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("arch_id", ARCHES)
def test_step_continues_reference(arch_id):
    """One reference step, the state carried across, then the second step:
    the loss in both packages, and the update from the reference's own
    gradients."""
    jarch, arch, jcfg, cfg, jparams, _ = _setup(arch_id)
    jstate = jopt.init_adamw(jparams)
    jb1, _ = _pair(_batch(arch_id, cfg, 32, seed=2))
    jparams, jstate, _ = jax.jit(jarch.step_fn(jcfg, "train_batch"))(
        jparams, jstate, jb1)
    model = port_recsys(jparams, cfg)
    state = port_adamw_state(jstate, model)
    jb, tb = _pair(_batch(arch_id, cfg, 32, seed=3))
    jl, jg = _jgrad(arch_id, jcfg)(jparams, jb)
    loss, _ = value_and_grad(arch.loss_fn(cfg, "train_batch"), model, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jparams2, jstate2 = jax.jit(functools.partial(jopt.adamw_update,
                                                  jarch.opt))(jg, jstate,
                                                              jparams)
    want_g = param_arrays(_np(jg), model)
    _, state2 = adamw_update(arch.opt, {k: torch.tensor(a)
                                        for k, a in want_g.items()},
                             state, model)
    want_p = param_arrays(_np(jparams2), model)
    for k, p in model.named_parameters():
        _assert_close_to_scale(p.detach().numpy(), want_p[k], k)
    for mine, ref in ((state2.mu, jstate2.mu), (state2.nu, jstate2.nu)):
        want = param_arrays(_np(ref), model)
        for k, t in mine.items():
            _assert_close_to_scale(t.numpy(), want[k], k)
    assert int(state2.step) == int(jstate2.step) == 2


# ---------------------------------------------------------------------------
# serve and retrieval against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHES)
def test_serve_matches_reference(arch_id):
    jarch, arch, jcfg, cfg, jparams, model = _setup(arch_id)
    jb, tb = _pair(_batch(arch_id, cfg, 64, seed=4, kind="serve"))
    got = arch.step_fn(cfg, "serve_bulk")(model, tb)
    want = jarch.step_fn(jcfg, "serve_bulk")(jparams, jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)


def _retrieval_inputs(arch_id, cfg, n, seed):
    """(batch of one user, candidate arrays) as numpy."""
    rng = np.random.default_rng(seed)
    user = _batch(arch_id, cfg, 1, seed, kind="serve")
    if arch_id == "dien":
        return user, [rng.integers(0, cfg.n_items, n).astype(np.int32),
                      rng.integers(0, cfg.n_cates, n).astype(np.int32)]
    if arch_id == "sasrec":
        user.pop("target")
        return user, [rng.integers(0, cfg.n_items, n).astype(np.int32)]
    return user, [rng.integers(0, cfg.vocab_sizes[0], n).astype(np.int32)]


@pytest.mark.parametrize("arch_id,optimized", [
    ("dien", False), ("sasrec", False), ("dcn-v2", False), ("dcn-v2", True)])
def test_retrieval_matches_reference(arch_id, optimized):
    jarch, arch, jcfg, cfg, jparams, model = _setup(arch_id)
    user, cands = _retrieval_inputs(arch_id, cfg, 256, seed=5)
    jb, tb = _pair(user)
    kw = dict(optimized=True) if optimized else {}
    got = arch.step_fn(cfg, "retrieval_cand", reduced=True, **kw)(
        model, tb, *[torch.from_numpy(c) for c in cands])
    want = jarch.step_fn(jcfg, "retrieval_cand", reduced=True, **kw)(
        jparams, jb, *[jnp.asarray(c) for c in cands])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)


def test_dcn_retrieve_variants_agree():
    _, arch, _, cfg, _, model = _setup("dcn-v2")
    user, (cand,) = _retrieval_inputs("dcn-v2", cfg, 256, seed=6)
    tb = {k: torch.from_numpy(v) for k, v in user.items()}
    cand = torch.from_numpy(cand)
    plain = arch.step_fn(cfg, "retrieval_cand", reduced=True)(model, tb, cand)
    opt = arch.step_fn(cfg, "retrieval_cand", reduced=True,
                       optimized=True)(model, tb, cand)
    torch.testing.assert_close(opt, plain, **RTOL)


@pytest.mark.parametrize("n,chunk", [(256, 64), (192, 64), (64, 64)])
def test_dien_score_candidates_chunked(n, chunk):
    """Chunked scores equal one chunk's, and ``dien_forward``'s on the same
    candidates (one user's history repeated; a prefix mask, so the
    history's clip-to-0 reads meet only masked steps)."""
    _, _, _, cfg, _, model = _setup("dien")
    user, (items, cates) = _retrieval_inputs("dien", cfg, n, seed=7)
    tb = {k: torch.from_numpy(v) for k, v in user.items()}
    items, cates = torch.from_numpy(items), torch.from_numpy(cates)
    got = recsys.dien_score_candidates(cfg, model, tb, items, cates, chunk)
    one = recsys.dien_score_candidates(cfg, model, tb, items, cates, n)
    torch.testing.assert_close(got, one, **RTOL)
    rep = {k: v.expand(n, *v.shape[1:]) for k, v in tb.items()}
    rep.update(target_item=items, target_cate=cates)
    with torch.no_grad():
        fwd = recsys.dien_forward(cfg, model, rep)
    torch.testing.assert_close(got, fwd, **RTOL)


# ---------------------------------------------------------------------------
# blocked pieces against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("augru", [False, True])
@pytest.mark.parametrize("last_only", [False, True])
def test_gru_scan_matches_plain(augru, last_only):
    g = torch.Generator().manual_seed(3)
    p = recsys.init_module(recsys.GRUParams(5, 7, torch.float64), g,
                           torch.device("cpu"))
    with torch.no_grad():
        p.b.normal_(generator=g)
    xs = torch.randn((6, 9, 5), generator=g, dtype=torch.float64)
    mask = (torch.rand((6, 9), generator=g) < 0.7).double()
    mask[0] = 0                                  # a row with no valid step
    a = torch.rand((6, 9), generator=g, dtype=torch.float64) if augru \
        else None
    leaves = [xs, p.wi, p.wh, p.b] + ([a] if augru else [])
    for t in leaves:
        t.requires_grad_(True)
    out = recsys.gru_scan(p, xs, mask, a, last_only=last_only)
    ref = recsys.gru_scan_ref(p, xs, mask, a)
    ref = ref[:, -1] if last_only else ref
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)
    w = torch.randn(ref.shape, generator=g, dtype=torch.float64)
    got = torch.autograd.grad((out * w).sum(), leaves)
    want = torch.autograd.grad((ref * w).sum(), leaves)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-12)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # carried zeros
    with torch.no_grad():
        torch.testing.assert_close(
            recsys.gru_scan(p, xs, mask, a, last_only=last_only), out,
            rtol=0, atol=0)


def test_sampled_logits_blocked_match_literal(monkeypatch):
    """Blocked negatives (forward and gradients) equal the literal formula,
    with ids < 0 (zeros, no gradient) and >= V (row V - 1) among them, at
    blocks of 2, 4 and 9 (all) batch rows."""
    g = torch.Generator().manual_seed(4)
    table = torch.randn((40, 6), generator=g, dtype=torch.float64)
    h = torch.randn((9, 5, 6), generator=g, dtype=torch.float64)
    neg = torch.randint(-3, 45, (9, 5, 7), generator=g)
    neg[0, 0, :3] = torch.tensor([-1, 39, 40])
    w = torch.randn((9, 5, 7), generator=g, dtype=torch.float64)
    outs = []
    for block in (2, 4, 9, None):
        t, hh = table.clone().requires_grad_(), h.clone().requires_grad_()
        if block is None:
            out = recsys.sampled_logits_ref(hh, t, neg)
        else:
            monkeypatch.setattr(recsys, "NEG_BLOCK", block)
            out = recsys.sampled_logits(hh, t, neg)
        outs.append((out,) + torch.autograd.grad((out * w).sum(), (hh, t)))
    ref = outs[-1]
    for got in outs[:-1]:
        for x, y in zip(got, ref):
            torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    dt = ref[2]
    assert dt[39].abs().sum() > 0
    ids = set(neg[neg >= 0].clamp_max(39).tolist())
    assert all(bool((dt[r] == 0).all()) for r in range(40) if r not in ids)


def test_sasrec_train_never_builds_the_negative_embeddings(monkeypatch):
    """The train step's loss goes through ``SampledLogits``, and its blocks
    hold at most ``NEG_BLOCK`` rows of negatives."""
    arch = get_arch("sasrec")
    cfg = arch.config(reduced=True)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    seen = []
    real = recsys.default_lookup

    def spy(table, ids):
        seen.append(tuple(ids.shape))
        return real(table, ids)
    monkeypatch.setattr(recsys, "default_lookup", spy)
    monkeypatch.setattr(recsys, "NEG_BLOCK", 8)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch("sasrec", cfg, 32, seed=8).items()}
    loss = recsys.sasrec_loss(cfg, model, batch)
    assert np.isfinite(float(loss))
    negs = [s for s in seen if len(s) == 3]
    assert negs and all(s[0] <= 8 for s in negs)


# ---------------------------------------------------------------------------
# reference quirks
# ---------------------------------------------------------------------------


def test_quirk_dcn_retrieve_opt_nan_for_out_of_range_ids():
    jarch, arch, jcfg, cfg, jparams, model = _setup("dcn-v2")
    user, (cand,) = _retrieval_inputs("dcn-v2", cfg, 8, seed=9)
    cand[3] = cfg.vocab_sizes[0]              # >= V
    user["sparse"][0, 2] = cfg.vocab_sizes[2] + 5
    jb, tb = _pair(user)
    for optimized in (False, True):
        got = arch.step_fn(cfg, "retrieval_cand", reduced=True,
                           optimized=optimized)(model, tb,
                                                torch.from_numpy(cand))
        want = np.asarray(jarch.step_fn(
            jcfg, "retrieval_cand", reduced=True, optimized=optimized)(
                jparams, jb, jnp.asarray(cand)))
        np.testing.assert_allclose(got.numpy(), want, **RTOL)
        assert np.isnan(got.numpy()).all() == optimized
    user["sparse"][0, 2] = 0
    jb, tb = _pair(user)
    opt = arch.step_fn(cfg, "retrieval_cand", reduced=True, optimized=True)(
        model, tb, torch.from_numpy(cand)).numpy()
    assert np.isnan(opt[3]) and np.isfinite(np.delete(opt, 3)).all()


def test_quirk_clip_to_zero_reads():
    """DIEN's candidate scoring reads the history by ``table[clip(ids,
    0)]`` (-1 reads row 0, not zeros) and the candidates by ``table[ids]``
    (-1 wraps to the last row); SASRec's serve and retrieve read by
    ``table[clip(ids, 0)]`` (-1 reads row 0, >= V clamps)."""
    jarch, arch, jcfg, cfg, jparams, model = _setup("dien")
    user, (items, cates) = _retrieval_inputs("dien", cfg, 64, seed=10)
    user["hist_items"][0, 0] = -1             # under mask 1
    user["mask"][0, 0] = 1.0
    items[:3] = [-1, cfg.n_items, cfg.n_items + 7]
    jb, tb = _pair(user)
    got = arch.step_fn(cfg, "retrieval_cand", reduced=True)(
        model, tb, torch.from_numpy(items), torch.from_numpy(cates))
    want = jarch.step_fn(jcfg, "retrieval_cand", reduced=True)(
        jparams, jb, jnp.asarray(items), jnp.asarray(cates))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)
    # dien_forward reads that -1 as zeros: another score
    rep = {k: v.expand(1, *v.shape[1:]) for k, v in tb.items()}
    rep.update(target_item=torch.from_numpy(items[3:4]),
               target_cate=torch.from_numpy(cates[3:4]))
    with torch.no_grad():
        assert not torch.allclose(recsys.dien_forward(cfg, model, rep),
                                  got[3:4], rtol=1e-6)

    jarch, arch, jcfg, cfg, jparams, model = _setup("sasrec")
    b = _batch("sasrec", cfg, 6, seed=11, kind="serve")
    b["target"][:3] = [-1, cfg.n_items, 0]
    jb, tb = _pair(b)
    got = arch.step_fn(cfg, "serve_p99")(model, tb).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jarch.step_fn(jcfg, "serve_p99")(jparams, jb)),
        **RTOL)
    assert got[0] != 0.0
    user, (cand,) = _retrieval_inputs("sasrec", cfg, 16, seed=12)
    cand[:2] = [-1, cfg.n_items + 3]
    jb, tb = _pair(user)
    got = arch.step_fn(cfg, "retrieval_cand", reduced=True)(
        model, tb, torch.from_numpy(cand)).numpy()
    want = np.asarray(jarch.step_fn(jcfg, "retrieval_cand", reduced=True)(
        jparams, jb, jnp.asarray(cand)))
    np.testing.assert_allclose(got, want, **RTOL)


def test_quirk_sasrec_fully_padded_query_rows():
    """A left-padded query position sees only padding keys: -1e30 gives it
    a uniform softmax over all S keys (finite states), as the reference."""
    jarch, arch, jcfg, cfg, jparams, model = _setup("sasrec")
    seq = np.full((3, cfg.seq_len), -1, np.int32)
    seq[0, -2:] = [5, 7]
    seq[1, :] = np.arange(cfg.seq_len)         # no padding
    jb, tb = _pair({"seq": seq})                # row 2: all padding
    got = recsys.sasrec_forward(cfg, model, tb["seq"])
    want = jrecsys.sasrec_forward(jcfg, jparams, jb["seq"])
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **RTOL)


def test_quirk_dien_masked_carry():
    """A masked step carries the state unchanged: zeroing a masked step's
    ids changes no logit, and a row with no valid step keeps h = 0."""
    jarch, arch, jcfg, cfg, jparams, model = _setup("dien")
    b = _batch("dien", cfg, 8, seed=13)
    b["mask"][0] = 0.0                          # no valid step
    b["mask"][1, 3] = 0.0                       # a hole inside the prefix
    jb, tb = _pair(b)
    got = recsys.dien_forward(cfg, model, tb)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jrecsys.dien_forward(jcfg, jparams, jb)), **RTOL)
    b2 = {k: v.copy() for k, v in b.items()}
    b2["hist_items"][1, 3] = 0
    b2["hist_cates"][1, 3] = 0
    tb2 = {k: torch.from_numpy(v) for k, v in b2.items()}
    torch.testing.assert_close(recsys.dien_forward(cfg, model, tb2), got,
                               rtol=0, atol=0)
    h_seq = torch.cat([recsys.default_lookup(model.item_emb,
                                             tb["hist_items"]),
                       recsys.default_lookup(model.cate_emb,
                                             tb["hist_cates"])], dim=-1)
    interests = recsys.gru_scan(model.gru1, h_seq, tb["mask"])
    assert not interests[0].any()
    torch.testing.assert_close(interests[1, 3], interests[1, 2], rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# models/common.py's public helpers
# ---------------------------------------------------------------------------


def test_mlp_layer_norm_swiglu_match_reference():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(7, 12)).astype(np.float32)
    ws = [rng.normal(size=(12, 9)).astype(np.float32),
          rng.normal(size=(9, 4)).astype(np.float32)]
    bs = [rng.normal(size=9).astype(np.float32),
          rng.normal(size=4).astype(np.float32)]
    t = torch.from_numpy
    for final_act in (False, True):
        np.testing.assert_allclose(
            common.mlp(t(x), [t(w) for w in ws], [t(b) for b in bs],
                       final_act=final_act).numpy(),
            np.asarray(jcommon.mlp(x, ws, bs, final_act=final_act)),
            rtol=1e-5, atol=1e-5)
    w, b = rng.normal(size=12).astype(np.float32), rng.normal(
        size=12).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        got = common.layer_norm(t(x).to(dt), t(w).to(dt), t(b).to(dt))
        want = jcommon.layer_norm(jnp.asarray(x).astype(
            jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32),
            jnp.asarray(w).astype(jnp.bfloat16 if dt == torch.bfloat16
                                  else jnp.float32),
            jnp.asarray(b).astype(jnp.bfloat16 if dt == torch.bfloat16
                                  else jnp.float32))
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-5 if dt == torch.float32 else 1e-2,
                                   atol=1e-5 if dt == torch.float32 else 2e-2)
    wg, wu = (rng.normal(size=(12, 16)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(16, 5)).astype(np.float32)
    np.testing.assert_allclose(
        common.swiglu(t(x), t(wg), t(wu), t(wd)).numpy(),
        np.asarray(jcommon.swiglu(x, wg, wu, wd)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch_id", ARCHES)
def test_losses_keep_float64(arch_id):
    """A float64 model's loss stays float64 (the CPU copies' reference
    runs): ``bce_with_logits`` promotes to fp32 at least, as
    ``cross_entropy`` does."""
    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.config(reduced=True), dtype=torch.float64)
    model = arch.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(arch_id, cfg, 8, seed=15).items()}
    assert arch.loss_fn(cfg, "train_batch")(model, batch).dtype == \
        torch.float64


def test_global_norm_is_accurate_on_large_gradients():
    """AdamW's clip scale on a table-sized gradient: within 1e-6 of the
    float64 norm (the CPU copies' AdamW step must match the card's)."""
    from repro_torch.train.optimizer import global_norm
    g = torch.Generator().manual_seed(16)
    grads = {"t": torch.randn((1 << 22, 2), generator=g) * 1e-3,
             "w": torch.randn((7, 5), generator=g)}
    grads["t"][::3] = 0.0
    want = float(sum((v.double() ** 2).sum() for v in grads.values()).sqrt())
    assert abs(float(global_norm(grads)) - want) <= 1e-6 * want
