"""Smoke test of the port's serving launcher, ``python -m
repro_torch.launch.serve``, on the CPU at a tiny corpus: closed loop
(with a failed shard answered by its mirror) and open loop through the
continuous-batching runtime.  It checks the printed summary, not speed.
"""
import ast
import re

import pytest

from repro_torch.launch.serve import main
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TINY = ["--n", "1200", "--d", "8", "--shards", "2", "--queries", "24",
        "--M", "8", "--gamma", "6", "--batch", "8", "--device", "cpu"]


def _recall(out):
    return float(re.search(r"recall@10(?: \(served\))? = ([0-9.]+)",
                           out).group(1))


@pytest.mark.parametrize("workload", ["contains", "equals"])
def test_closed_loop(capsys, workload):
    main(TINY + ["--workload", workload, "--fail-shard", "1"])
    out = capsys.readouterr().out
    assert "built 2 shards over n=1200" in out
    assert "shard 1 marked failed" in out
    assert "served 24 hybrid queries" in out
    assert _recall(out) > 0.8
    assert "'duplicated_dispatches': 3" in out


def test_open_loop(capsys):
    main(TINY + ["--mode", "open", "--rate", "2000", "--request-size", "4",
                 "--ef-ladder", "16,32", "--slo-budget", "30"])
    out = capsys.readouterr().out
    assert "open loop: 24 queries at 2000.0 req/s" in out
    assert "shed 0/24" in out
    assert _recall(out) > 0.8
    sizes = re.search(r"batch sizes (\{.*\})", out).group(1)
    assert sum(k * v for k, v in ast.literal_eval(sizes).items()) == 24


def test_open_loop_sheds_over_a_small_queue(capsys):
    main(TINY + ["--mode", "open", "--rate", "100000", "--max-queue", "4",
                 "--coalesce-deadline", "1"])
    out = capsys.readouterr().out
    shed = int(re.search(r"shed (\d+)/24", out).group(1))
    assert 0 < shed < 24
