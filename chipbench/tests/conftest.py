"""Fixtures of the benchmark's CPU tests.

Run from the repo root: ``python -m pytest -q chipbench/tests``.  Tests
that need the card take ``cuda_device`` and skip here; the decision is
made inside the fixture, never at import."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each cell cut to a size a CPU test holds: rows and clusters of the
# corpus, queries a request and requests checked
TINY = {"sift1m-lcps": {"n": 3000, "clusters": 8},
        "tripclick-hcps": {"n": 4096, "clusters": 16}}
TINY_MIX = {"batch": 32, "check_requests": 4, "trace_requests": 1,
            "warmup_requests": 1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def tiny_cell(name: str):
    """The cell of ``BENCHMARK.json`` with its corpus cut to ``TINY``."""
    from chipbench import harness
    cell = harness.load_cell(name, ROOT)
    cell.config["dataset"].update(TINY[cell.config["name"]])
    cell.mix.update(TINY_MIX)
    return cell


CELLS = ("sift1m-lcps.graph", "tripclick-hcps.selective")
