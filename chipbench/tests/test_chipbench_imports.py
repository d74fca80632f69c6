"""Nothing a run loads is JAX or the JAX package; the reference loads
nothing of the program under test."""
import ast
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT

RUN = """
import sys, time
sys.path[:0] = [{tests!r}, {root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from conftest import tiny_cell
from chipbench import harness
cell = tiny_cell({cell!r})
out = harness.run_cell(cell, 2**31 + 99, 0.5, False, torch.device("cpu"),
                       time.perf_counter())
assert out.tally.requests > 0, "no request was compared"
print("HELD", ",".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = RUN.format(tests=str(ROOT / "chipbench" / "tests"),
                      root=str(ROOT), src=str(ROOT / "src"), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    held = out.stdout.split("HELD ", 1)[1].split()[0].split(",")
    assert "repro_torch" in held
    assert not set(held) & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import chipbench.reference.knn, chipbench.reference.predicates\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    held = set(eval(out.stdout))
    assert not held & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    for f in (ROOT / "chipbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in {"__future__", "typing",
                                              "numpy", "torch", "chipbench"}, (
                    f"{f.name} imports {name}")
                assert not name.startswith("chipbench.") or \
                    name.startswith("chipbench.reference"), f.name


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    """Only BENCHMARK.json and chipbench/: the run exits non-zero and
    prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
