"""The port's dry run (``python -m repro_torch.launch.dryrun --all``), once,
in a subprocess of its own: every (arch, cell) of the registry at the
16 x 16 and 2 x 16 x 16 production meshes, counted on ``meta`` tensors over
a fake process group of 256, then 512 ranks, nothing allocated and no
kernel built.  Its records are held to the reference's registry (the same
cells, the same skips), to hand counts (acorn ``serve_1m``'s FLOPs and
collective bytes), to ``model_flops`` (each LM's ``train_4k``) and to
``torch.utils.flop_counter.FlopCounterMode`` (the same step's dot-class
FLOPs), and :mod:`repro_torch.launch.report` renders them."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as ref_arch
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import dryrun, report
from repro_torch.launch.op_cost import OpCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHES = ["smollm-360m", "qwen3-8b", "gemma3-27b",
             "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]
MESHES = ("16x16", "2x16x16")
SWEEP_TIMEOUT_S = 900
MAX_RSS_BYTES = 4 << 30

# the module run as ``python -m`` runs it, with the kernel loader refused
# and, at exit, the launch counters and the process's peak RSS printed
_RUN = r"""
import json, resource, runpy, sys
from repro_torch.kernels import loader

def refuse():
    raise AssertionError("the dry run reached the kernel loader")
loader.library = refuse
sys.argv = ["repro_torch.launch.dryrun", "--all", "--out", sys.argv[1]]
code = 0
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code
finally:
    from repro_torch.kernels import (embedding_bag, filtered_topk,
                                     gather_distance, neighbor_expand,
                                     pna_aggregate)
    launches = {m.__name__: getattr(m, m.__name__.rsplit(".", 1)[-1]
                                    + "_cuda").launches
                for m in (embedding_bag, filtered_topk, gather_distance,
                          neighbor_expand, pna_aggregate)}
    print("LAUNCHES=" + json.dumps(launches))
    print("MAXRSS_KB=%d" % resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
sys.exit(code)
"""


@pytest.fixture(scope="module")
def sweep_proc(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _RUN, str(out)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def sweep(sweep_proc):
    proc, out = sweep_proc
    try:
        log, _ = proc.communicate(timeout=SWEEP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        pytest.fail("the dry run outlived its timeout:\n" + log[-4000:])
    lines = log.splitlines()
    stats = {k: v for k, _, v in (ln.partition("=") for ln in lines
                                  if ln.startswith(("LAUNCHES=",
                                                    "MAXRSS_KB=")))}
    recs = report.load(str(out))
    return dict(rc=proc.returncode, log=log, recs=recs,
                by_tag={(r["arch"], r["shape"], r["mesh"]): r for r in recs},
                launches=json.loads(stats["LAUNCHES"]),
                max_rss=int(stats["MAXRSS_KB"]) * 1024)


def test_flop_counter_agrees_on_lm_dot_flops(sweep_proc, request):
    """Each LM arch's ``train_4k`` step (one rank's whole step, as
    ``sharded_step`` runs it) under ``FlopCounterMode`` on ``meta``
    tensors, here while the sweep runs: its FLOPs (matmul-class only)
    within 3 % of the sweep's dot-class FLOPs of the same step."""
    counted = {}
    for arch_id in LM_ARCHES:
        arch = get_arch(arch_id)
        cfg = arch.config(shape="train_4k")
        args = dryrun.meta_inputs(arch, cfg, "train_4k")
        with FlopCounterMode(display=False) as fc:
            arch.step_fn(cfg, "train_4k")(*args)
        counted[arch_id] = fc.get_total_flops()
    recs = request.getfixturevalue("sweep")["by_tag"]
    for arch_id in LM_ARCHES:
        for mesh in MESHES:
            dot = recs[arch_id, "train_4k", mesh]["dot_flops_per_chip"]
            assert dot == pytest.approx(counted[arch_id], rel=0.03), \
                (arch_id, mesh)


def test_every_cell_has_a_record(sweep):
    assert sweep["rc"] == 0, sweep["log"][-4000:]
    want = {(a, c.shape, m) for a in ARCH_IDS for c in get_arch(a).cells()
            for m in MESHES}
    assert len(want) == 84
    assert set(sweep["by_tag"]) == want and len(sweep["recs"]) == 84
    assert not [r for r in sweep["recs"] if r["status"] == "failed"]


def test_skips(sweep):
    """The registry's skips as the reference records them, and no other:
    no step reads the device on the host (DIEN's ``retrieval_cand`` runs
    every history step and keeps the state with ``torch.where``), so DIEN
    ``retrieval_cand`` is counted at both meshes."""
    for (a, shape, mesh), r in sweep["by_tag"].items():
        ref = {c.shape: c for c in ref_arch(a).cells()}[shape]
        if ref.skip:
            assert r["status"] == "skipped" and r["reason"] == ref.skip
    registry = {(a, s) for a, s, _ in sweep["by_tag"]
                if {c.shape: c for c in get_arch(a).cells()}[s].skip}
    assert registry == {(a, "long_500k") for a in (
        "smollm-360m", "qwen3-8b", "moonshot-v1-16b-a3b",
        "deepseek-v2-lite-16b")}
    others = {(a, s, m): r["reason"] for (a, s, m), r in
              sweep["by_tag"].items()
              if r["status"] == "skipped" and (a, s) not in registry}
    assert others == {}
    for mesh in MESHES:
        assert sweep["by_tag"]["dien", "retrieval_cand", mesh]["status"] == \
            "ok"


def test_nothing_allocated_or_launched(sweep):
    """Terabytes of arguments, counted in a few hundred MB: every tensor
    is ``meta``, no kernel is built or launched."""
    assert sweep["max_rss"] < MAX_RSS_BYTES
    assert sweep["launches"] and not any(sweep["launches"].values())
    args = sum(r["memory_analysis"]["argument_size_in_bytes"]
               * r["chips"] for r in sweep["recs"] if r["status"] == "ok")
    assert args > 1e12


def test_acorn_serve_1m_hand_count(sweep):
    """16 x 16: a rank's 4,096 corpus rows against 512 queries (2·512·
    4096·512 FLOPs), and the two all-gathers of the (512, 10) scores and
    ids, over ``data`` to (512, 160), then over ``model`` to (512, 2560)."""
    r = sweep["by_tag"]["acorn", "serve_1m", "16x16"]
    assert r["chips"] == 256 and r["compute"] == "sharded"
    rf = r["roofline"]
    assert rf["flops_per_chip"] == pytest.approx(2 * 512 * 4096 * 512,
                                                 rel=0.05)
    gathered = (512 * 160 + 512 * 2560) * (4 + 4)
    assert gathered == 11_141_120
    assert rf["collective_bytes_per_chip"] == pytest.approx(gathered,
                                                            rel=0.05)
    assert rf["collectives"]["all-gather"]["count"] == 4


def test_lm_train_flops_against_model_flops(sweep):
    """A rank runs the whole ``train_4k`` step: its counted FLOPs over
    6·N·D lie in [1.25, 2.75] (remat's forward recompute, fp32
    attention, MoE capacity), and ``useful_flops_ratio`` is that over
    the chips."""
    for arch_id in LM_ARCHES:
        for mesh in MESHES:
            r = sweep["by_tag"][arch_id, "train_4k", mesh]
            rf = r["roofline"]
            ratio = rf["flops_per_chip"] / rf["model_flops"]
            assert 1.25 <= ratio <= 2.75, (arch_id, mesh, ratio)
            assert r["compute"] == "replicated"
            assert rf["useful_flops_ratio"] == pytest.approx(
                1 / (ratio * r["chips"]))


def test_two_tower_retrieval_counts_filtered_topk(monkeypatch):
    """The one-device ``retrieval_cand`` step (user tower, then
    ``filtered_topk``) on ``meta`` tensors: the kernel is counted once
    through its router's ``record_kernel``, and never built or
    launched."""
    from repro_torch.kernels import loader
    from repro_torch.kernels.filtered_topk import filtered_topk_cuda

    def refuse():
        raise AssertionError("a meta tensor reached the kernel loader")
    monkeypatch.setattr(loader, "library", refuse)
    arch = get_arch("two-tower-retrieval")
    cfg = arch.config(shape="retrieval_cand")
    args = dryrun.meta_inputs(arch, cfg, "retrieval_cand")
    before = filtered_topk_cuda.launches
    with OpCounter() as c:
        ids, scores = arch.step_fn(cfg, "retrieval_cand")(*args)
    assert ids.device.type == "meta" and tuple(ids.shape) == (1, 100)
    k = c.kernels["filtered_topk"]
    # one query, 2^20 candidates of 256: 2 d per (query, row)
    assert k["count"] == 1 and k["flops"] == 2 * 256 * (1 << 20)
    assert filtered_topk_cuda.launches == before


def test_two_tower_retrieval_mesh_step(sweep):
    """The dry run takes two-tower's mesh step, as the reference lowers
    it (its ``step_fn`` takes ``mesh``): a rank scores its 2^20 / chips
    candidates (matmul, no kernel), then the two-axis all-gather of its
    (1, 100) scores and ids."""
    for mesh in MESHES:
        r = sweep["by_tag"]["two-tower-retrieval", "retrieval_cand", mesh]
        assert r["status"] == "ok" and r["compute"] == "sharded"
        assert r["kernels"] == {}
        rf = r["roofline"]
        assert rf["flops_per_chip"] >= 2 * 256 * (1 << 20) // r["chips"]
        assert rf["flops_per_chip"] < 2 * 256 * (1 << 20) // 16
        assert rf["collectives"]["all-gather"]["count"] == 2 * len(
            mesh.split("x"))
    assert sweep["launches"]["repro_torch.kernels.filtered_topk"] == 0


def test_dien_retrieval_runs_on_meta_without_a_host_read():
    """DIEN's ``retrieval_cand`` step (REDUCED: 256 candidates in chunks of
    64) on ``meta`` tensors, where any read of a value on the host raises:
    it runs to its (256,) scores, every history step of every chunk
    counted (the AUGRU's recurrent product once a step and chunk)."""
    arch = get_arch("dien")
    cfg = arch.config(reduced=True)
    args = dryrun.meta_inputs(arch, cfg, "retrieval_cand", reduced=True)
    with OpCounter() as counter:
        out = arch.step_fn(cfg, "retrieval_cand", reduced=True)(*args)
    assert out.device.type == "meta" and tuple(out.shape) == (256,)
    steps = args[1]["mask"].shape[1]
    assert counter.by_op["mm"]["count"] >= (256 // 64) * steps


@pytest.mark.parametrize("read", [
    lambda t: t.sum().item(),
    lambda t: t.tolist(),
    lambda t: torch.nonzero(t > 0),
    lambda t: t[t > 0],
    lambda t: torch.masked_select(t, t > 0),
    lambda t: torch.unique(t),
    lambda t: t.numpy(),
])
def test_host_reads_are_skips(read):
    """A read of a value on the host, or an output shaped by the data,
    raises on ``meta`` tensors as a host read: its cell is skipped."""
    with pytest.raises(Exception) as info:
        read(torch.empty(6, device="meta"))
    assert dryrun.is_host_read(info.value)


@pytest.mark.parametrize("exc", [
    NotImplementedError("a stub of the port"),
    NotImplementedError("aten::foo: attempted to run this operator with "
                        "Meta tensors, but there was no fake impl"),
    RuntimeError("shape mismatch"),
])
def test_other_errors_are_not_host_reads(exc):
    """A stub's ``NotImplementedError``, an op without a meta function and
    any other error fail their cell."""
    assert not dryrun.is_host_read(exc)


def test_report_renders_the_records(sweep):
    summary = report.dryrun_summary(sweep["recs"])
    assert summary.startswith("cells: 76 counted OK, 8 skipped "
                              "(documented), 0 failed")
    table = report.roofline_table(sweep["recs"], "16x16").splitlines()
    assert len(table) == 2 + 42
    row = next(ln for ln in table if ln.startswith("| smollm-360m | "
                                                   "train_4k |"))
    assert "replicated" in row and "bf16 " in row and "fp32 " in row
