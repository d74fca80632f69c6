"""bounded_sorted_merge in the PyTorch port against the JAX reference.

Random beams and candidates with deliberate ties (values drawn from a
small set, shared between beam and candidates) and +inf entries; the
merged distances and every payload must be identical to the reference's,
for both the merge and its stable-argsort oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.filtered_topk.merge import (
    bounded_sorted_merge as jax_merge,
    bounded_sorted_merge_ref as jax_merge_ref)
from repro_torch.kernels.filtered_topk import (bounded_sorted_merge,
                                               bounded_sorted_merge_ref)

B, L, C = 6, 16, 7


def _inputs(seed):
    rng = np.random.default_rng(seed)
    vals = np.array([0.5, 1.0, 1.0, 2.0, 3.5, np.inf], np.float32)
    beam = np.sort(rng.choice(vals, size=(B, L)), axis=1).astype(np.float32)
    cand = rng.choice(vals, size=(B, C)).astype(np.float32)
    beam_ids = rng.integers(-1, 100, size=(B, L)).astype(np.int32)
    cand_ids = rng.integers(-1, 100, size=(B, C)).astype(np.int32)
    beam_f = rng.random((B, L)) < 0.5
    cand_f = rng.random((B, C)) < 0.5
    return beam, cand, (beam_ids, beam_f), (cand_ids, cand_f)


@pytest.mark.parametrize("which", ["merge", "ref"])
@pytest.mark.parametrize("seed", range(4))
def test_merge_matches_reference(seed, which):
    beam, cand, bp, cp = _inputs(seed)
    jfn, tfn = ((jax_merge, bounded_sorted_merge) if which == "merge"
                else (jax_merge_ref, bounded_sorted_merge_ref))
    jd, jp = jfn(jnp.asarray(beam), jnp.asarray(cand),
                 tuple(jnp.asarray(a) for a in bp),
                 tuple(jnp.asarray(a) for a in cp))
    td, tp = tfn(torch.from_numpy(beam), torch.from_numpy(cand),
                 tuple(torch.from_numpy(a) for a in bp),
                 tuple(torch.from_numpy(a) for a in cp))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    for a, b in zip(tp, jp):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_merge_equals_its_oracle():
    for seed in range(10, 20):
        beam, cand, bp, cp = _inputs(seed)
        args = (torch.from_numpy(beam), torch.from_numpy(cand),
                tuple(torch.from_numpy(a) for a in bp),
                tuple(torch.from_numpy(a) for a in cp))
        d1, p1 = bounded_sorted_merge(*args)
        d2, p2 = bounded_sorted_merge_ref(*args)
        assert torch.equal(d1, d2)
        assert all(torch.equal(a, b) for a, b in zip(p1, p2))
