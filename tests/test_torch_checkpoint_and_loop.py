"""The port's checkpoint manager, AdamW and training loop against the JAX
reference: twins of ``tests/test_checkpoint_and_loop.py`` (roundtrip,
atomicity, retention, async save, restart-resume determinism, NaN circuit
breaker, grad accumulation), each run on the same numpy-seeded data in
both packages where the reference has a number to compare.

Tolerances: the schedule within rtol 1e-6 (fp32 cosines); ``adamw_update``
fed the reference's own gradients within rtol 1e-6 / atol 1e-9 for fp32
parameters and moments, and within one bf16 step (rtol 2^-8) for a bf16
parameter (fp32 results within 1e-6 may round to neighbouring bf16
values); loops whose gradients each package computes itself: final
weights within rtol 1e-5, logged losses within rtol 1e-4 (60 steps of
fp32 sums in another order, amplified by Adam's normalisation, on losses
down at the data's noise floor of ~1e-4).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, make_train_step, run
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, global_norm,
                                         init_adamw, schedule)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "nested": {"b": torch.arange(4.0)}}


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(tree)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(10, t, extra={"note": "x"})
    restored, step = mgr.restore(t)
    assert step == 10
    want, got = _leaves(t), _leaves(restored)
    assert list(want) == list(got) == ["nested/b", "w"]
    for k in want:
        assert torch.equal(want[k], got[k])
    assert mgr.manifest(10)["extra"]["note"] == "x"
    # the same file layout as the reference's: arrays.npz + manifest.json
    assert sorted(os.listdir(tmp_path / "step_00000010")) == [
        "arrays.npz", "manifest.json"]


def test_roundtrip_bf16_state_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    p = {"a": torch.randn(5).to(torch.bfloat16), "b": torch.randn(3, 2)}
    state = init_adamw(p)
    mgr.save(3, (p, state))
    (p2, s2), step = mgr.restore((p, state), device="cpu")
    assert step == 3 and isinstance(s2, AdamWState)
    assert p2["a"].dtype == torch.bfloat16 and torch.equal(p2["a"], p["a"])
    assert torch.equal(p2["b"], p["b"]) and s2.step.dtype == torch.int32
    assert sorted(_leaves((p, state))) == sorted(
        mgr.manifest(3)["keys"])


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = _tree()
    before = t["w"].clone()
    mgr.save(5, t)
    t["w"].add_(1.0)          # the loop goes on updating in place
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(t)[0]["w"], before)


def test_missing_key_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        mgr.restore({"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_reference_checkpoint_keys_match(tmp_path):
    """The port names a nested dict's leaves as the reference does."""
    jt = {"w": jnp.zeros((2, 2)), "nested": {"b": jnp.zeros(3)}}
    JCheckpointManager(str(tmp_path / "j")).save(1, jt)
    mgr = CheckpointManager(str(tmp_path / "t"))
    mgr.save(1, {"w": torch.zeros(2, 2), "nested": {"b": torch.zeros(3)}})
    assert (mgr.manifest(1)["keys"]
            == JCheckpointManager(str(tmp_path / "j")).manifest(1)["keys"])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_adamw(params)

    def loss(p):
        return (p["w"] ** 2).sum()

    for _ in range(50):
        g = {"w": 2 * params["w"]}
        params, state = adamw_update(cfg, g, state, params)
    assert float(loss(params)) < 1.0


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(schedule(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert float(schedule(cfg, torch.tensor(100))) <= 0.1 + 1e-6


@pytest.mark.parametrize("cfg", [
    AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=30),
    AdamWConfig(warmup_steps=0, total_steps=0)])
def test_schedule_matches_reference(cfg):
    jcfg = jopt.AdamWConfig(**vars(cfg))
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jopt.schedule(jcfg, jnp.asarray(steps)))
    got = schedule(cfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def _adamw_case(seed=0):
    """Parameters (fp32 matrix, fp32 bias, bf16 vector) and three steps of
    gradients; step 2's are scaled so their global norm (~40) exceeds the
    clip of 1."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "h": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.05, 8.0, 0.1)]
    return params, grads


def test_adamw_update_matches_reference_from_the_same_grads():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(**vars(cfg))
    p_np, g_np = _adamw_case()
    bf = {"h"}

    def jcast(k, a):
        return jnp.asarray(a, jnp.bfloat16 if k in bf else jnp.float32)

    def tcast(k, a):
        return torch.from_numpy(a).to(torch.bfloat16 if k in bf
                                      else torch.float32)

    jp = {k: jcast(k, a) for k, a in p_np.items()}
    tp = {k: tcast(k, a) for k, a in p_np.items()}
    js, ts = jopt.init_adamw(jp), init_adamw(tp)
    clipped = []
    for g in g_np:
        jg = {k: jcast(k, a) for k, a in g.items()}
        tg = {k: tcast(k, a) for k, a in g.items()}
        norm = float(global_norm(tg))
        np.testing.assert_allclose(norm, float(jopt.global_norm(jg)),
                                   rtol=1e-6)
        clipped.append(norm > cfg.grad_clip)
        jp, js = jopt.adamw_update(jcfg, jg, js, jp)
        tp, ts = adamw_update(cfg, tg, ts, tp)
        assert int(ts.step) == int(js.step)
        for k in p_np:
            assert tp[k].dtype == (torch.bfloat16 if k in bf
                                   else torch.float32)
            want = np.asarray(jp[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            if k in bf:
                np.testing.assert_allclose(got, want, rtol=2 ** -8)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
            for mine, ref in ((ts.mu, js.mu), (ts.nu, js.nu)):
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(ref[k]), rtol=1e-6,
                                           atol=1e-12)
    assert clipped == [False, True, False]


# ---------------------------------------------------------------------------
# training loop: run, checkpoint, resume
# ---------------------------------------------------------------------------


def _np_batches(seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(4,)).astype(np.float32)
    while True:
        x = rng.normal(size=(32, 4)).astype(np.float32)
        y = x @ w_true + 0.01 * rng.normal(size=32).astype(np.float32)
        yield x, y


def _data_iter(seed=0):
    for x, y in _np_batches(seed):
        yield {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _jdata_iter(seed=0):
    for x, y in _np_batches(seed):
        yield {"x": jnp.asarray(x), "y": jnp.asarray(y)}


def _loss(params, batch):
    pred = batch["x"] @ params["w"]
    return ((pred - batch["y"]) ** 2).mean()


def _jloss(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _jopt(cfg):
    return jopt.AdamWConfig(**vars(cfg))


def test_loop_learns_and_checkpoints(tmp_path):
    opt = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=60,
                      weight_decay=0.0)
    res = run(_loss, {"w": torch.zeros(4)}, _data_iter(), TrainConfig(
        total_steps=60, ckpt_every=20, log_every=5,
        ckpt_dir=str(tmp_path), async_ckpt=False), opt)
    losses = dict(res["losses"])
    assert losses[55] < losses[0] * 0.2
    assert CheckpointManager(str(tmp_path)).latest_step() == 60
    ref = jloop.run(_jloss, {"w": jnp.zeros(4)}, _jdata_iter(),
                    jloop.TrainConfig(total_steps=60, ckpt_every=100,
                                      log_every=5, ckpt_dir=None),
                    _jopt(opt))
    assert [s for s, _ in res["losses"]] == [s for s, _ in ref["losses"]]
    np.testing.assert_allclose([v for _, v in res["losses"]],
                               [v for _, v in ref["losses"]], rtol=1e-4)


def test_loop_resume_matches_uninterrupted(tmp_path):
    opt = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=40,
                      weight_decay=0.0)
    res_full = run(_loss, {"w": torch.zeros(4)}, _data_iter(),
                   TrainConfig(total_steps=40, ckpt_every=100,
                               log_every=1, ckpt_dir=None), opt)
    d = str(tmp_path)
    run(_loss, {"w": torch.zeros(4)}, _data_iter(),
        TrainConfig(total_steps=20, ckpt_every=20, log_every=1,
                    ckpt_dir=d, async_ckpt=False), opt)
    res_resumed = run(_loss, {"w": torch.zeros(4)}, _data_iter(),
                      TrainConfig(total_steps=40, ckpt_every=20,
                                  log_every=1, ckpt_dir=d,
                                  async_ckpt=False), opt)
    assert res_resumed["steps"] == 20
    np.testing.assert_allclose(res_full["params"]["w"].numpy(),
                               res_resumed["params"]["w"].numpy(),
                               rtol=1e-5)
    ref = jloop.run(_jloss, {"w": jnp.zeros(4)}, _jdata_iter(),
                    jloop.TrainConfig(total_steps=40, ckpt_every=100,
                                      log_every=1, ckpt_dir=None),
                    _jopt(opt))
    np.testing.assert_allclose(res_resumed["params"]["w"].numpy(),
                               np.asarray(ref["params"]["w"]), rtol=1e-5)


def test_loop_nan_circuit_breaker():
    def bad_loss(params, batch):
        return torch.log(-(params["w"] ** 2).sum() - 1.0)  # always nan

    with pytest.raises(FloatingPointError):
        run(bad_loss, {"w": torch.ones(4)}, _data_iter(),
            TrainConfig(total_steps=5, log_every=1, ckpt_dir=None),
            AdamWConfig())


def test_loop_reads_the_loss_only_on_logged_steps():
    """A NaN on an unlogged step is not seen until a logged one."""
    def nan_after_first(params, batch):
        bad = (params["w"] != 1.0).any()
        return torch.where(bad, float("nan"), 0.0) + (params["w"] * 0).sum()

    res = run(nan_after_first, {"w": torch.ones(4)}, _data_iter(),
              TrainConfig(total_steps=4, log_every=4, ckpt_dir=None),
              AdamWConfig(lr=0.0))
    assert res["losses"] == [(0, 0.0), (3, 0.0)]
    with pytest.raises(FloatingPointError, match="step 3"):
        run(nan_after_first, {"w": torch.ones(4)}, _data_iter(),
            TrainConfig(total_steps=4, log_every=4, ckpt_dir=None),
            AdamWConfig(lr=0.1, warmup_steps=0))


def test_grad_accumulation_matches_full_batch():
    opt = AdamWConfig(lr=0.01, warmup_steps=0, weight_decay=0.0)
    batch = next(_data_iter())
    s1 = make_train_step(_loss, opt, microbatches=1)
    s4 = make_train_step(_loss, opt, microbatches=4)
    p1 = {"w": torch.ones(4)}
    p4 = {"w": torch.ones(4)}
    _, _, l1 = s1(p1, init_adamw(p1), batch)
    _, _, l4 = s4(p4, init_adamw(p4), batch)
    np.testing.assert_allclose(p1["w"].numpy(), p4["w"].numpy(), atol=1e-5)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    jbatch = next(_jdata_iter())
    jp = {"w": jnp.ones(4)}
    jp4, _, jl4 = jloop.make_train_step(_jloss, _jopt(opt), microbatches=4)(
        jp, jopt.init_adamw(jp), jbatch)
    np.testing.assert_allclose(p4["w"].numpy(), np.asarray(jp4["w"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(l4), float(jl4), rtol=1e-5)
    assert not p4["w"].requires_grad      # grad was on for the step only
