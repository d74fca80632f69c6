"""The port's mesh collectives (``make_sharded_lookup``,
``split_kv_decode_attention``, ``quantize_int8`` / ``compressed_psum``) on
8 ``gloo`` ranks of a (4, 2) ("data", "model") mesh, against the
reference's on an 8-device JAX mesh of the same shape, on the same numpy
inputs.  The reference runs once, in a subprocess with
``--xla_force_host_platform_device_count=8`` (jax fixes the device count
at its first init); the ranks once, each passing its blocks (``place``).

Cases: lookup ids of -1 and >= V (both read zeros, as no shard owns them);
a query with no valid key (zeros, not NaN) and a shard with none; an
all-zero x (scale 1e-12); values exactly half-way between two int8 steps
(rounded to even); the error feedback carried over two steps.  The
lookup, the int8 codes, scales and residuals must match bit for bit; the
attention within 1e-6; the means within 1e-6 of the largest |value| (the
four shards' sum may run in another order).

The ranks import this module, so it imports nothing of JAX at module
level.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import (compressed_psum, get_mesh,
                                                 make_sharded_lookup,
                                                 quantize_int8,
                                                 split_kv_decode_attention)
from repro_torch.distributed.sharding import P, place
from torch_parity import run_ranks

MESH = ((4, 2), ("data", "model"))
PSUM_CASES = ("normal", "zeros", "halfway")
PSUM_KEYS = ("m1", "e1", "q1", "s1", "m2", "e2", "q2", "s2")
V = 64
HALF_STEPS = (0.5, 1.5, 2.5, -0.5, -2.5)    # round half to even:
HALF_CODES = (0, 2, 2, 0, -2)               # their codes

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.collectives import (compressed_psum,
    make_sharded_lookup, quantize_int8, split_kv_decode_attention)

inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4, 2), ("data", "model"))

def put(x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

out = {}
out["lookup"] = make_sharded_lookup(mesh, dp="data", tp="model")(
    put(inp["table"], P("model", None)), put(inp["ids"], P("data", None)))
seq = P(None, "data")
out["attn"] = split_kv_decode_attention(mesh, seq_axis="data")(
    jnp.asarray(inp["q"]), put(inp["k"], seq), put(inp["v"], seq),
    put(inp["valid"], seq))

def two_steps(x1, x2):
    m1, e1 = compressed_psum(x1, "data")
    q1, s1 = quantize_int8(x1)
    m2, e2 = compressed_psum(x2, "data", error=e1)
    q2, s2 = quantize_int8(x2 + e1)
    return m1, e1, q1, s1, m2, e2, q2, s2

f = shard_map(two_steps, mesh=mesh, in_specs=(P("data", None),) * 2,
              out_specs=(P("data", None),) * 8, check_vma=False)
for name in sys.argv[3].split(","):
    res = f(jnp.asarray(inp[name + "_1"]), jnp.asarray(inp[name + "_2"]))
    for key, r in zip(sys.argv[4].split(","), res):
        out[name + "/" + key] = r
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("REFERENCE_OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, V + 6, size=(8, 5)).astype(np.int32)
    ids[0, :3] = (-1, V, V + 5)               # unowned: zeros
    b, s, h, hd = 3, 32, 4, 8
    valid = rng.random((b, s)) < 0.6
    valid[0] = np.arange(s) < 20              # shard 3 (rows 24-31): none
    valid[1] = False                          # no valid key anywhere
    out = dict(table=rng.normal(size=(V, 16)).astype(np.float32), ids=ids,
               q=rng.normal(size=(b, h, hd)).astype(np.float32),
               k=rng.normal(size=(b, s, h, hd)).astype(np.float32),
               v=rng.normal(size=(b, s, h, hd)).astype(np.float32),
               valid=valid)
    for step in (1, 2):
        out[f"normal_{step}"] = rng.normal(size=(8, 64)).astype(np.float32)
        out[f"zeros_{step}"] = np.zeros((8, 64), np.float32)
        # each shard's max |x| is 127 x a power of two, so its scale is
        # that power exactly and every other value lies half-way
        half = np.zeros((8, 64), np.float32)
        for shard, scale in enumerate((1.0, 0.5, 2.0, 0.25)):
            rows = slice(2 * shard, 2 * shard + 2)
            k = rng.integers(-126, 126, size=(2, 64))
            half[rows] = (k + 0.5) * scale
            half[2 * shard, 0] = 127 * scale * (1 if step == 1 else -1)
            half[2 * shard + 1, :5] = np.array(HALF_STEPS) * scale
        out[f"halfway_{step}"] = half
    return out


def _rank(rank, world, inp):
    mesh = get_mesh(*MESH)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {"coordinate": mesh.coordinate}
    table, ids = place((t["table"], t["ids"]),
                       (P("model", None), P("data", None)), mesh)
    out["lookup"] = make_sharded_lookup(mesh, "data", "model")(table, ids)
    seq = P(None, "data")
    args = place((t["q"], t["k"], t["v"], t["valid"]), (P(), seq, seq, seq),
                 mesh)
    out["attn"] = split_kv_decode_attention(mesh, "data")(*args)
    for name in PSUM_CASES:
        x1, x2 = place((t[name + "_1"], t[name + "_2"]),
                       (P("data", None),) * 2, mesh)
        m1, e1 = compressed_psum(x1, mesh, "data")
        q1, s1 = quantize_int8(x1)
        m2, e2 = compressed_psum(x2, mesh, "data", error=e1)
        q2, s2 = quantize_int8(x2 + e1)
        for key, r in zip(PSUM_KEYS, (m1, e1, q1, s1, m2, e2, q2, s2)):
            out[f"{name}/{key}"] = r
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's whole outputs, each rank's outputs)."""
    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz"), ",".join(PSUM_CASES), ",".join(PSUM_KEYS)],
        env=env, capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr
    ref = dict(np.load(tmp / "out.npz"))
    return inp, ref, run_ranks(_rank, 8, tmp, inp)


def _data_rows(arr, coord, parts=4):
    n = arr.shape[0] // parts
    return arr[coord[0] * n:(coord[0] + 1) * n]


def test_sharded_lookup_matches_reference(runs):
    inp, ref, ranks = runs
    ids, table = inp["ids"], inp["table"]
    ok = (ids >= 0) & (ids < V)
    plain = np.where(ok[..., None], table[np.clip(ids, 0, V - 1)], 0.0)
    np.testing.assert_array_equal(ref["lookup"], plain)
    for r in ranks:
        got = r["lookup"]
        assert got.shape == (2, 5, 16) and got.dtype == np.float32
        np.testing.assert_array_equal(got, _data_rows(ref["lookup"],
                                                      r["coordinate"]))
    # ids of -1 and >= V read zeros (default_lookup would clamp >= V)
    assert not ref["lookup"][0, :3].any()


def test_split_kv_attention_matches_reference(runs):
    inp, ref, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["attn"], ref["attn"], rtol=0, atol=1e-6)
        assert not r["attn"][1].any()        # no valid key: exact zeros
        assert np.isfinite(r["attn"]).all()
    # row 0's keys all lie in shards 0-2: the softmax over them alone
    q, k, v = inp["q"][0], inp["k"][0, :20], inp["v"][0, :20]
    s = np.einsum("hd,shd->hs", q.astype(np.float64), k)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("hs,shd->hd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(ranks[0]["attn"][0], want, atol=1e-5)


@pytest.mark.parametrize("name", PSUM_CASES)
def test_compressed_psum_matches_reference(runs, name):
    inp, ref, ranks = runs
    for r in ranks:
        c = r["coordinate"]
        for key in PSUM_KEYS:
            want = _data_rows(ref[f"{name}/{key}"], c)
            got = r[f"{name}/{key}"]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if key.startswith("m"):
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=1e-6 * max(float(np.abs(want).max()), 1e-30),
                    err_msg=key)
            else:                       # codes, scales, residuals: bits
                np.testing.assert_array_equal(got.view(np.uint8),
                                              want.view(np.uint8),
                                              err_msg=key)


def test_quantize_quirks(runs):
    """All-zero x: scale 1e-12 and zero codes; half-way values round to
    even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2); the second step quantizes x +
    the first step's residual."""
    inp, ref, ranks = runs
    assert np.all(ref["zeros/s1"] == np.float32(1e-12))
    assert not ref["zeros/q1"].any() and not ref["zeros/m2"].any()
    x = inp["halfway_1"]
    scale = np.repeat(ref["halfway/s1"], 2, axis=0)
    np.testing.assert_array_equal(scale[::2, 0], [1.0, 0.5, 2.0, 0.25])
    np.testing.assert_array_equal(ref["halfway/q1"],
                                  np.round(x / scale).astype(np.int8))
    k = x / scale
    assert np.all(k[np.abs(k) < 127] % 1 == 0.5)
    for r in ranks:
        q1 = r["halfway/q1"]
        np.testing.assert_array_equal(q1[1, :5], HALF_CODES)
    np.testing.assert_array_equal(ref["halfway/e1"],
                                  x - ref["halfway/q1"] * scale)
    # the mean over the four data shards, within the reference test's bound
    want = np.repeat(inp["normal_1"].reshape(4, 2, 64).mean(0)[None], 4,
                     0).reshape(8, 64)
    for r in ranks:
        err = np.abs(r["normal/m1"] - _data_rows(want, r["coordinate"]))
        assert err.max() / np.abs(want).max() < 0.05
