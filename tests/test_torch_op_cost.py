"""The port's per-op cost counter (``repro_torch.launch.op_cost``) against
the reference's loop-aware HLO cost model (``repro.launch.hlo_cost``) on
the same programs: the JAX side compiled on the CPU and its HLO text
counted, the port's run eagerly on the same numpy inputs under
``OpCounter``.  Loops are unrolled by the port (every iteration is
dispatched) and multiplied by their trip counts in the reference."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_cost import analyze_hlo
from repro_torch.launch.op_cost import OpCounter, tensor_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 0.05


def _hlo(f, *args):
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text())


def _count(f, *args) -> OpCounter:
    with OpCounter() as c:
        f(*args)
    return c


def _flops(c: OpCounter) -> float:
    return sum(c.flops.values())


@pytest.fixture(scope="module")
def xw():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((256, 256), dtype=np.float32),
            rng.standard_normal((256, 256), dtype=np.float32))


def test_matmul_tanh_matches_hlo_cost(xw):
    x, w = xw
    want = _hlo(lambda a, b: jnp.tanh(a @ b), x, w)
    c = _count(lambda a, b: torch.tanh(a @ b), torch.from_numpy(x),
               torch.from_numpy(w))
    assert _flops(c) == pytest.approx(want.flops, rel=RTOL)
    assert _flops(c) == pytest.approx(2 * 256 ** 3 + 256 ** 2, rel=1e-9)
    assert c.dot_flops == 2 * 256 ** 3
    # operands + outputs of the matmul and the tanh, fp32
    assert c.bytes == 4 * 256 * 256 * (3 + 2)


def test_batched_einsum_flops():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 64, 32), dtype=np.float32)
    b = rng.standard_normal((4, 32, 16), dtype=np.float32)
    want = 2 * 4 * 64 * 16 * 32
    ref = _hlo(lambda p, q: jnp.einsum("bij,bjk->bik", p, q), a, b)
    c = _count(lambda p, q: torch.einsum("bij,bjk->bik", p, q),
               torch.from_numpy(a), torch.from_numpy(b))
    assert ref.flops == pytest.approx(want, rel=RTOL)
    assert _flops(c) == pytest.approx(want, rel=RTOL)
    assert c.dot_flops == want


@pytest.mark.parametrize("loops", [(8,), (3, 4)], ids=["8", "3x4"])
def test_loops_count_every_iteration(xw, loops):
    """A loop of 8 matmuls counts 8x one matmul, nested 3 x 4 loops 12x,
    as the reference counts a scan body by its trip count."""
    x, w = xw
    trips = int(np.prod(loops))

    def scanned(a, b):
        def body(c, _):
            return c @ b, None
        if len(loops) == 1:
            return jax.lax.scan(body, a, None, length=loops[0])[0]

        def outer(c, _):
            return jax.lax.scan(body, c, None, length=loops[1])[0], None
        return jax.lax.scan(outer, a, None, length=loops[0])[0]

    def unrolled(a, b):
        for _ in range(trips):
            a = a @ b
        return a

    one_ref = _hlo(lambda a, b: a @ b, x, w)
    ref = _hlo(scanned, x, w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    one = _count(lambda a, b: a @ b, tx, tw)
    got = _count(unrolled, tx, tw)
    assert ref.flops / one_ref.flops == pytest.approx(trips, rel=RTOL)
    assert _flops(got) / _flops(one) == pytest.approx(trips, rel=RTOL)
    assert _flops(got) == pytest.approx(ref.flops, rel=RTOL)


def test_gather_counts_rows_not_table():
    """8 rows of a 100,000 x 64 table: the rows moved and the ids, not
    the 25.6 MB table (the reference's bound: under 1e5 bytes)."""
    table = torch.empty((100_000, 64), device="meta")
    ids = torch.empty((8,), dtype=torch.int32, device="meta")
    rng = np.random.default_rng(2)
    ref = _hlo(lambda t, i: t[i],
               jax.ShapeDtypeStruct((100_000, 64), jnp.float32),
               jax.ShapeDtypeStruct((8,), jnp.int32))
    assert ref.bytes < 1e5
    for op, f, idx_bytes in (
            ("index", lambda t, i: t[i.long()], 8),
            ("index_select", lambda t, i: torch.index_select(t, 0, i), 4),
            ("embedding", lambda t, i: torch.nn.functional.embedding(i, t),
             4)):
        c = _count(f, table, ids)
        assert c.bytes < 1e5
        assert c.by_op[op]["bytes"] == 2 * 8 * 64 * 4 + 8 * idx_bytes
    # an indexed write counts the values it adds, not the whole table
    vals = torch.from_numpy(rng.standard_normal((8, 64), dtype=np.float32))
    dense = torch.zeros((100_000, 64))
    c = _count(lambda t, i, v: t.index_add_(0, i, v), dense,
               torch.arange(8), vals)
    assert c.bytes == 2 * 8 * 64 * 4 + 8 * 8


def test_checkpointed_layer_forward_counted_twice(xw):
    """Under backward a non-reentrant checkpoint reruns its forward: the
    layer's matmul and tanh are counted twice, its backward once."""
    x, w = (torch.from_numpy(a) for a in xw)

    def layer(a, b):
        return torch.tanh(a @ b)

    def loss(ckpt):
        wg = w.clone().requires_grad_(True)
        y = (torch.utils.checkpoint.checkpoint(layer, x, wg,
                                               use_reentrant=False)
             if ckpt else layer(x, wg))
        y.sum().backward()

    plain, ckpt = _count(loss, False), _count(loss, True)
    assert plain.by_op["tanh"]["count"] == 1
    assert ckpt.by_op["tanh"]["count"] == 2
    # forward mm, then d/dw = x^T g: one more matmul under the recompute
    assert ckpt.dot_flops - plain.dot_flops == 2 * 256 ** 3
    assert plain.by_op["mm"]["count"] + 1 == ckpt.by_op["mm"]["count"]


def test_peak_live_bytes():
    """A known live set on meta: the argument (4,000 B) and at most two
    4,000-B intermediates at a time."""
    a = torch.empty(1000, device="meta")

    def step(t):
        b = t * 2.0
        c = b + 1.0
        del b
        d = c * 3.0
        del c
        e = d.sum()
        return e

    c = OpCounter()
    c.add_arguments((a,))
    with c:
        out = step(a)
    c.add_outputs(out)
    m = c.memory
    assert m["argument_size_in_bytes"] == 4000
    assert m["peak_live_size_in_bytes"] == 4000 + 2 * 4000
    assert m["output_size_in_bytes"] == 4
    assert m["temp_size_in_bytes"] == 8000
    # an update in place aliases its argument
    c2 = OpCounter()
    c2.add_arguments((a,))
    with c2:
        out = a.mul_(2.0)
    c2.add_outputs(out)
    assert c2.memory["alias_size_in_bytes"] == 4000
    assert c2.memory["output_size_in_bytes"] == 0


def test_expanded_view_read_once():
    t = torch.empty((1, 64), device="meta").expand(1000, 64)
    assert tensor_bytes(t) == 64 * 4


_COLLECTIVES = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.op_cost import OpCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
x = torch.empty((64, 8), device="meta")      # a rank's (64, 64 / 8) block
with OpCounter() as c:
    for _ in range(5):
        s = x.clone()
        dist.all_reduce(s)
        x = x + 0 * s
dist.destroy_process_group()
ar = c.coll.get("all-reduce", {"count": 0, "bytes": 0})
assert ar["count"] == 5, ar
assert ar["bytes"] == 5 * 2 * 64 * 8 * 4, ar
assert c.coll_bytes == ar["bytes"], c.coll
print("COLL_OK")
"""


def test_collectives_counted_in_a_loop():
    """The twin of ``test_collectives_counted_with_loop_multiplier``: 5
    all-reduces over a fake group of 8 ranks are counted as 5, at 2x
    their bytes (the ring model)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env,
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert "COLL_OK" in r.stdout, r.stdout + r.stderr
