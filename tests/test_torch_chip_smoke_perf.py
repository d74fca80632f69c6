"""``chip_smoke.py``'s ``perf`` phase on CPU tensors, at the REDUCED
configs.

The phase calls the perf twin's timing functions
(``repro_torch.launch.perf``) with the launch counters zeroed: on the CPU
nothing is timed and no kernel launches (``filtered_topk`` takes its plain
version), but every check runs, with the twin's own tolerances: the
chunked scan's ids equal the baseline's, the bf16 corpus overlaps it by
0.9, ``filtered_topk``'s ids equal it but at near ties, DCN-v2's
``retrieve_opt`` within 1e-5 of ``retrieve``, smollm's bf16-logits loss
within 2e-2 of the fp32 one.  A ``[perf]`` line a variant.
"""
import importlib.util
import os
import re

import pytest
import torch

from repro_torch.launch import perf
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_perf_phase_runs_on_cpu_tensors(smoke, capsys):
    out = smoke.perf_phase(torch.device("cpu"), reduced=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[perf] cell=")]
    assert len(lines) == len(perf.ACORN_VARIANTS) + 4
    for ln in lines:
        kv = dict(re.findall(r"(\w+)=(\S+)", ln))
        assert kv["ms"] == "None" and kv["flop_share"] == "None"
    acorn = out["acorn serve_25m"]
    assert list(acorn) == [v for v, _, _ in perf.ACORN_VARIANTS]
    assert acorn["opt1: chunked running top-k"]["check"]["near_ties"] == 0
    assert "near_ties" in acorn["filtered_topk (CUDA)"]["check"]
    assert out["dcn-v2 retrieval_cand"][
        "opt: hoist constant user features"]["check"]["max_abs_err"] <= 1e-5
    assert out["smollm-360m train_4k"]["pure_dp + bf16 logits"]["check"][
        "loss_rel_err"] <= 2e-2
    assert not any(out["kernel_launches"].values())
    assert "filtered_topk_block" not in out        # timed on the card only


def test_perf_phase_cut(smoke):
    """The phase's smollm step: 2 layers at B = 1 of the full cut."""
    assert smoke.PERF_SMOLLM == (2, 1)
    layers, b = smoke.LM_CUTS["smollm-360m"]["train_4k"]
    assert smoke.PERF_SMOLLM[0] < layers and smoke.PERF_SMOLLM[1] < b


def test_perf_phase_refuses_a_bf16_corpus_off_the_fp32_ranking(
        smoke, monkeypatch):
    """The twin's gates raise through the phase: an overlap floor above 1
    fails the bf16 corpus."""
    monkeypatch.setattr(perf, "BF16_OVERLAP_MIN", 1.01)
    with pytest.raises(AssertionError, match="overlap"):
        smoke.perf_phase(torch.device("cpu"), reduced=True)
