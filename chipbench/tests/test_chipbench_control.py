"""The check fails what it must: the control (the reference in TF32 in
the program's place) and a run whose timed path is broken underneath;
and passes a sound run."""
import time

import pytest
import torch

from chipbench import harness, judge
from chipbench.control import control_tally
from chipbench.faults import FAULTS, GRAPH_ONLY

from conftest import CELLS, tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_control_reads_not_correct(cell, seed):
    c = tiny_cell(cell)
    tally = control_tally(c, seed, CPU)
    ok, rows = judge.verdict(tally, c.limits, 0)
    assert tally.requests > 0 and not ok, rows


# rows of the tiny graph cell where a fault needs more than the default
# to show: a beam stopped after one expansion still finds most of a
# 250-row label at 3,000 rows (recall_miss 0.31), misses half at 12,000
# (0.54) and 0.90 at the cell's own size (PERF.md)
FAULT_ROWS = {"one_hop": 12000}


def run(cell, wrapper=None, rows=None):
    torch.set_num_threads(2)
    c = tiny_cell(cell)
    if rows:
        c.config["dataset"]["n"] = rows
    return harness.run_cell(c, 2**31 + 41, 0.5, False, CPU,
                            time.perf_counter(), search_wrapper=wrapper)


@pytest.mark.parametrize("cell,rows", [(c, None) for c in CELLS]
                         + [(CELLS[0], FAULT_ROWS["one_hop"])])
def test_sound_run_reads_correct(cell, rows):
    out = run(cell, rows=rows)
    assert out.result["correct"], out.check_rows
    assert list(out.result)[-1] == "check"


BROKEN = [(cell, fault) for cell in CELLS for fault in FAULTS
          if cell == CELLS[0] or fault not in GRAPH_ONLY]


@pytest.mark.parametrize("cell,fault", BROKEN)
def test_broken_timed_path_reads_not_correct(cell, fault):
    out = run(cell, FAULTS[fault], FAULT_ROWS.get(fault))
    assert not out.result["correct"], out.check_rows


def test_control_on_the_card(cuda_device):
    """The control at the cell's own size on the card: not correct."""
    c = harness.load_cell(CELLS[0], harness.BENCH_DIR.parent)
    tally = control_tally(c, 5, cuda_device)
    assert not judge.verdict(tally, c.limits, 0)[0]
