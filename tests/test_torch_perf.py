"""The perf twin (``python -m repro_torch.launch.perf``) against the
reference's ``repro/launch/perf.py``.

Its ``main`` runs once, ``--reduced --device cpu``, in a subprocess of its
own (its fake process group of 256 ranks dies with it): three records
with the reference's variants and keys, plus ``timed`` and ``compute``;
what the counts say of each variant.  In process: the ``filtered_topk``
variant's outputs against the baseline's, DCN-v2's ``retrieve_opt``
against ``retrieve``, smollm's bf16-logits loss against the reference's
(``logits_f32=False``), the ``flop_share`` gate and the entry the
reference models (``filtered_topk`` on a bf16 corpus), counted here.
Tolerances are the twin's own gates (``perf.py``'s constants) unless a
test says otherwise.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import perf
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import (HBM_BYTES_PER_S,
                                         ROOFLINE_FLOP_SHARE_MAX, Roofline)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro" / "launch" / "perf.py"
RUN_TIMEOUT_S = 120

# the reference's variants per cell (src/repro/launch/perf.py), the port's
# name beside each: the modeled Pallas f32 entry is the CUDA kernel run, the
# modeled bf16 entry the kernel run on a bf16 corpus
REFERENCE_VARIANTS = {
    "acorn__serve_25m": [
        ("baseline (materialized scores)", "baseline (materialized scores)"),
        ("opt1: chunked running top-k", "opt1: chunked running top-k"),
        ("opt2: chunked + bf16 corpus", "opt2: chunked + bf16 corpus"),
        ("pallas filtered_topk (modeled, f32)", "filtered_topk (CUDA)"),
        ("pallas filtered_topk (modeled, bf16)",
         "filtered_topk (modeled, bf16)")],
    "smollm-360m__train_4k": [
        ("baseline", "baseline"), ("pure_dp", "pure_dp"),
        ("pure_dp + bf16 logits", "pure_dp + bf16 logits")],
    "dcn-v2__retrieval_cand": [
        ("baseline (broadcast ids)", "baseline (broadcast ids)"),
        ("opt: hoist constant user features",
         "opt: hoist constant user features")],
}
REFERENCE_KEYS = {"variant", "hypothesis", "roofline"}
ROOFLINE_KEYS = {"flops_per_chip", "bytes_per_chip",
                 "collective_bytes_per_chip", "t_compute", "t_memory",
                 "t_collective", "bottleneck", "model_flops",
                 "useful_flops_ratio", "collectives"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("perf_torch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--reduced",
         "--device", "cpu", "--out", str(out)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}
    return recs, proc.stdout


def by_variant(records, cell):
    return {e["variant"]: e for e in records[0][cell]}


def test_records_have_the_reference_variants_and_keys(records):
    recs, log = records
    text = REFERENCE.read_text()
    assert sorted(recs) == sorted(REFERENCE_VARIANTS)
    for cell, pairs in REFERENCE_VARIANTS.items():
        assert [e["variant"] for e in recs[cell]] == [p for _, p in pairs]
        for ref_name, _ in pairs:
            assert f'"{ref_name}' in text, ref_name
        for e in recs[cell]:
            assert REFERENCE_KEYS | {"timed", "compute", "count_s",
                                     "kernels", "note"} == set(e), cell
            assert ROOFLINE_KEYS <= set(e["roofline"])
            assert e["variant"] in log
    for cell in recs:
        for e in recs[cell]:
            modeled = e["roofline"].get("modeled", False)
            assert (e["timed"] is None) == modeled
            if not modeled:
                t = e["timed"]
                assert t["device"] == "cpu" and t["calls"] == 5
                assert t["ms"] is None and t["flop_share"] is None
                assert t["reduced"] and t["counted"]["flops"] > 0


def test_compute_is_sharded_only_for_acorn(records):
    for cell in REFERENCE_VARIANTS:
        want = "sharded" if cell.startswith("acorn") else "replicated"
        assert {e["compute"] for e in records[0][cell]} == {want}


def test_smollm_layouts_differ_only_in_the_collective_term(records):
    """``sharded_step`` runs the whole step on every rank in either
    layout: the same FLOPs; bytes within 0.01 % (the gathered blocks'
    own copies); the collective bytes differ.  bf16 logits count as fp32
    logits do: the loss upcasts them eagerly."""
    v = by_variant(records, "smollm-360m__train_4k")
    base, dp, bf = (v[n]["roofline"] for n in ("baseline", "pure_dp",
                                               "pure_dp + bf16 logits"))
    assert base["t_compute"] == dp["t_compute"]
    assert base["t_memory"] == pytest.approx(dp["t_memory"], rel=1e-4)
    assert base["t_collective"] != dp["t_collective"]
    assert bf["t_compute"] == dp["t_compute"]
    assert bf["bytes_per_chip"] == dp["bytes_per_chip"]
    for e in v.values():
        assert "sharded_step" in e["note"]


# the acorn cell's counting half at full size (98,304 rows a rank), in a
# fake group of its own
_ACORN_FULL = r"""
import json
from repro_torch.launch import dryrun, perf
with dryrun.fake_group(perf.RANKS):
    print(json.dumps(perf.acorn_counted()))
"""


@pytest.fixture(scope="module")
def acorn_full():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _ACORN_FULL], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {e["variant"]: e for e in json.loads(proc.stdout)}


def test_acorn_byte_counts(acorn_full):
    """Per-op bytes at ``serve_25m``'s rank block: the bf16 corpus counts
    fewer than the fp32 scan and ``filtered_topk`` fewer than the
    baseline; the fp32 scan counts every pass over its score blocks, so it
    stays within 2 % above the baseline's (the reference's predicted Tm /4
    needs fusion).  The baseline's FLOPs are the rank's matmul, 2 B n d."""
    b = {k: e["roofline"]["bytes_per_chip"] for k, e in acorn_full.items()}
    flops = acorn_full["baseline (materialized scores)"]["roofline"][
        "flops_per_chip"]
    assert flops == pytest.approx(2 * 512 * (3 << 23) // 256 * 512,
                                  rel=0.01)
    assert b["opt2: chunked + bf16 corpus"] < b["opt1: chunked running top-k"]
    assert b["filtered_topk (CUDA)"] < b["baseline (materialized scores)"]
    assert 1.0 <= (b["opt1: chunked running top-k"]
                   / b["baseline (materialized scores)"]) < 1.02


KERNEL_VARIANTS = ("filtered_topk (CUDA)", "filtered_topk (modeled, bf16)")


def test_filtered_topk_variant_counts_the_kernel(records):
    v = by_variant(records, "acorn__serve_25m")
    for name in KERNEL_VARIANTS:
        k = v[name]
        assert k["kernels"]["filtered_topk"]["count"] == 1
        assert k["timed"]["counted"]["kernels"]["filtered_topk"][
            "count"] == 1
    for name, e in v.items():
        if name not in KERNEL_VARIANTS:
            assert e["kernels"] == {}, name
        else:
            assert set(e["kernels"]) == {"filtered_topk"}


def test_modeled_entry_uses_the_card_figures(records):
    """The entry the reference models (``filtered_topk`` on a bf16 corpus)
    is counted here, not modeled: the kernel's cost formula at 2 bytes a
    corpus element (the fp32 kernel's bytes less half its corpus block's),
    the same FLOPs, the H100's HBM rate in its memory term, the baseline's
    collective term; its note says the port times what the reference
    modeled."""
    v = by_variant(records, "acorn__serve_25m")
    e = v["filtered_topk (modeled, bf16)"]
    m, f32 = e["roofline"], v["filtered_topk (CUDA)"]["roofline"]
    assert not m.get("modeled", False) and e["timed"] is not None
    spec = perf.REDUCED_ACORN_SHAPES["serve_25m"]
    rows = spec["n"] // perf.RANKS
    kb16 = e["kernels"]["filtered_topk"]["bytes"]
    kb32 = v["filtered_topk (CUDA)"]["kernels"]["filtered_topk"]["bytes"]
    assert kb32 - kb16 == 2 * rows * spec["d"]
    assert e["kernels"]["filtered_topk"]["flops"] == v[
        "filtered_topk (CUDA)"]["kernels"]["filtered_topk"]["flops"]
    assert m["t_compute"] == f32["t_compute"]
    assert m["bytes_per_chip"] < f32["bytes_per_chip"]
    assert m["t_memory"] == pytest.approx(m["bytes_per_chip"]
                                          / HBM_BYTES_PER_S)
    base = v["baseline (materialized scores)"]["roofline"]
    assert m["t_collective"] == base["t_collective"]
    assert "reference models" in e["note"]


def test_dcn_variants_gather_the_same_bytes(records):
    v = by_variant(records, "dcn-v2__retrieval_cand")
    a, b = (e["roofline"] for e in v.values())
    assert a["collective_bytes_per_chip"] == b["collective_bytes_per_chip"]
    assert b["bytes_per_chip"] < a["bytes_per_chip"]


def test_filtered_topk_outputs_equal_the_baseline_on_cpu():
    """The ``filtered_topk`` step (its router's plain version on CPU
    tensors) and the baseline step on the same REDUCED inputs: ids
    identical (the data has no near ties), dists within ``DIST_ATOL``."""
    spec = perf.REDUCED_ACORN_SHAPES["serve_25m"]
    x, q, m = perf.acorn_inputs(spec["n"], spec["d"], spec["batch"],
                                torch.device("cpu"))
    m[0, 20:] = False                       # fewer passing rows than k
    mesh = make_host_mesh()
    args = get_arch("acorn").place_inputs("serve_25m", mesh, x, q, m)
    ids, d = perf.filtered_topk_step(mesh)(*args)
    want_ids, want_d = perf._acorn_step(mesh, True)(*args)
    assert torch.equal(ids, want_ids)
    assert (ids[0] >= 0).sum() == m[0].sum()
    check = perf.check_topk(ids, d, want_ids, want_d, q, x, "cpu",
                            exact=True)
    assert check["max_abs_err"] <= perf.DIST_ATOL


def test_acorn_timed_checks_on_cpu():
    recs = perf.acorn_timed("cpu", reduced=True)
    assert recs["opt1: chunked running top-k"]["check"]["near_ties"] == 0
    assert recs["opt2: chunked + bf16 corpus"]["check"]["overlap"] >= \
        perf.BF16_OVERLAP_MIN
    assert recs["filtered_topk (CUDA)"]["shape"]["corpus_dtype"] == \
        "float32"
    bf = recs["filtered_topk (modeled, bf16)"]
    assert bf["shape"]["corpus_dtype"] == "bfloat16"
    assert bf["check"]["overlap"] >= perf.BF16_OVERLAP_MIN


def test_check_topk_refuses_a_wrong_id():
    spec = perf.REDUCED_ACORN_SHAPES["serve_25m"]
    x, q, m = perf.acorn_inputs(spec["n"], spec["d"], spec["batch"],
                                torch.device("cpu"))
    mesh = make_host_mesh()
    ids, d = perf._acorn_step(mesh, True)(*get_arch("acorn").place_inputs(
        "serve_25m", mesh, x, q, m))
    bad = ids.clone()
    bad[0, 0] = ids[0, -1]
    with pytest.raises(AssertionError, match="not a near tie"):
        perf.check_topk(bad, d, ids, d, q, x, "doctored")
    with pytest.raises(AssertionError, match="ids differ"):
        perf.check_topk(bad, d, ids, d, q, x, "doctored", exact=True)


def test_dcn_retrieve_opt_equals_retrieve():
    recs = perf.dcn_timed("cpu", reduced=True)
    assert recs[True]["check"]["max_abs_err"] <= perf.DCN_ATOL
    assert recs[False]["shape"] == {"n_candidates": 256}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smollm_bf16_logits_loss_matches_reference(dtype):
    """REDUCED smollm (its fp32 config, and the same in bf16) with
    ``logits_f32=False`` in both packages, the reference's weights
    carried across by ``convert.lm_params_from_arrays``: losses within
    rtol 1e-2."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jax_get_arch
    from repro.models import transformer as jt
    from torch_parity import port_lm
    jarch = jax_get_arch("smollm-360m")
    jcfg = dataclasses.replace(jarch.config(reduced=True), logits_f32=False,
                               dtype=getattr(jnp, dtype))
    params = jarch.init(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_arch("smollm-360m").config(reduced=True),
                              logits_f32=False, dtype=getattr(torch, dtype))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)
    want = float(jt.lm_loss(jcfg, params, jnp.asarray(ids[:, :-1]),
                            jnp.asarray(ids[:, 1:])))
    model = port_lm(params, cfg)
    got = float(get_arch("smollm-360m").loss_fn(cfg, "train_4k")(
        model, {"tokens": torch.from_numpy(ids[:, :-1]),
                "labels": torch.from_numpy(ids[:, 1:])}))
    np.testing.assert_allclose(got, want, rtol=1e-2)


def test_smollm_timed_losses_on_cpu():
    recs = perf.smollm_timed("cpu", reduced=True)
    assert recs[False]["check"]["loss_rel_err"] <= perf.LOSS_RTOL
    assert recs[True]["shape"]["layers"] == 2


def test_flop_share_gate():
    """A step timed faster than its counted FLOPs at the card's peaks
    fails; at the limit it passes."""
    roof = Roofline(flops={"fp32": 67e9}, bytes_accessed=3.35e9,
                    collective_bytes=0.0)            # 1 ms of each
    assert perf.shares(roof, 2.0) == pytest.approx((0.5, 0.5))
    assert perf.shares(roof, 1.0 / ROOFLINE_FLOP_SHARE_MAX)[0] == \
        pytest.approx(ROOFLINE_FLOP_SHARE_MAX)
    with pytest.raises(AssertionError, match="flop_share"):
        perf.shares(roof, 0.9)
    assert perf.shares(roof, None) == (None, None)


def test_smollm_timed_cut_is_chip_smokes():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert perf.SMOLLM_TIMED == smoke.LM_CUTS["smollm-360m"]["train_4k"]
