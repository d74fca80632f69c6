"""The port's H100 roofline (``repro_torch.launch.roofline``): its terms,
its dtype split and bottleneck, its record keys against the reference's
``repro.launch.roofline``, the card's constants defined in that one
module, and ``chip_smoke.py``'s ``[roofline]`` lines on the CPU at the
REDUCED configs."""
import importlib.util
import pathlib
import re

import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro_torch.launch import roofline
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.roofline import (HBM_BYTES_PER_S, LINK_BYTES_PER_S,
                                         PEAK_BF16_PER_S, PEAK_FP32_PER_S,
                                         Roofline, analyze)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _matmul_roof(dtype) -> Roofline:
    a = torch.empty((4096, 4096), dtype=dtype, device="meta")
    with OpCounter() as c:
        a @ a
    return analyze(c)


def test_fp32_matmul_compute_term():
    r = _matmul_roof(torch.float32)
    assert r.flops["fp32"] == 2 * 4096 ** 3
    assert r.t_compute == pytest.approx(2 * 4096 ** 3 / 67e12, rel=1e-12)
    # two operands read, the output written
    assert r.t_memory == pytest.approx(3 * 4096 ** 2 * 4 / 3.35e12,
                                       rel=1e-12)
    assert r.bottleneck == "compute"


def test_dtype_split():
    bf = _matmul_roof(torch.bfloat16)
    assert bf.flops == {"bf16": 2 * 4096 ** 3, "fp32": 0.0, "other": 0.0}
    assert bf.t_compute == pytest.approx(2 * 4096 ** 3 / PEAK_BF16_PER_S)
    mixed = Roofline(flops={"bf16": 989e12, "fp32": 67e12, "other": 67e12},
                     bytes_accessed=0.0, collective_bytes=0.0)
    assert mixed.t_compute_by_dtype == pytest.approx(
        {"bf16": 1.0, "fp32": 1.0, "other": 1.0})
    assert mixed.t_compute == pytest.approx(3.0)


@pytest.mark.parametrize("flops,nbytes,coll,want", [
    (67e12, 0.0, 0.0, "compute"),
    (0.0, 3.35e12, 0.0, "memory"),
    (0.0, 3.35e12, 2 * 50e9, "collective"),
])
def test_bottleneck(flops, nbytes, coll, want):
    r = Roofline(flops={"fp32": flops}, bytes_accessed=nbytes,
                 collective_bytes=coll)
    assert r.bottleneck == want
    assert r.t_bound == max(r.t_compute, r.t_memory, r.t_collective)
    assert r.t_collective == coll / LINK_BYTES_PER_S


def test_to_dict_has_the_reference_keys():
    mine = Roofline(flops={"bf16": 1e15, "fp32": 1e12}, bytes_accessed=1e9,
                    collective_bytes=1e6, model_flops=1e17).to_dict(256)
    ref = ref_roofline.Roofline(flops=1.0, bytes_accessed=1.0,
                                collective_bytes=1.0).to_dict(256)
    assert set(ref) <= set(mine)
    assert mine["flops_per_chip"] == 1e15 + 1e12
    assert mine["useful_flops_ratio"] == pytest.approx(1e17 / (1.001e15
                                                               * 256))
    assert mine["bottleneck"] == "compute"


def test_h100_constants_defined_once():
    """The card's peaks live in ``launch/roofline.py`` only: no other port
    file and not ``chip_smoke.py`` assigns them or spells their values."""
    assert (PEAK_BF16_PER_S, PEAK_FP32_PER_S, HBM_BYTES_PER_S,
            LINK_BYTES_PER_S) == (989e12, 67e12, 3.35e12, 50e9)
    values = re.compile(r"\b(989e12|67e12|3\.35e12|50e9|450e9)\b")
    names = re.compile(r"^\s*(PEAK_\w+|HBM_BYTES_PER_S|LINK_BYTES_PER_S|"
                       r"NVLINK_BYTES_PER_S)\s*=", re.M)
    home = pathlib.Path(roofline.__file__).resolve()
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        if path.resolve() == home:
            continue
        text = path.read_text()
        assert not values.search(text), path
        assert not names.search(text), path


def test_perf_twin_reads_the_card_constants():
    """``launch/perf.py`` and ``chip_smoke.py`` read the peaks and the
    ``flop_share`` limit from ``launch/roofline.py``: neither assigns
    them, and the perf twin spells no H100 value and none of the
    reference perf.py's TPU constants (its HBM rate, bf16 peak and
    modeled terms)."""
    assert roofline.ROOFLINE_FLOP_SHARE_MAX == 1.05
    perf = ROOT / "src" / "repro_torch" / "launch" / "perf.py"
    text = perf.read_text()
    assert "from repro_torch.launch.roofline import" in text
    assert not re.search(r"\b(989e12|67e12|3\.35e12|50e9|450e9)\b", text)
    for tpu in ("819e9", "197e12", "2.62e-04", "2.62e-4", "2.23e-04",
                "2.23e-4", "1.1e7"):
        assert tpu not in text, tpu
    for path in (perf, ROOT / "chip_smoke.py"):
        assert not re.search(r"^\s*(ROOFLINE_FLOP_SHARE_MAX|PEAK_\w+|"
                             r"HBM_BYTES_PER_S)\s*=", path.read_text(),
                             re.M), path


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reduced_counts(smoke):
    return smoke.roofline_counts(reduced=True)


def test_chip_smoke_counts_every_timed_step(smoke, reduced_counts):
    names = [name for name, _ in smoke.roofline_steps(reduced=True)]
    assert sorted(reduced_counts) == sorted(names + ["seconds"])
    assert len(names) == len(smoke.ROOFLINE_ACORN) + 2 * len(
        smoke.LM_ARCHES) + 1
    for name in names:
        c = reduced_counts[name]
        assert c["counted_flops"] >= c["dot_flops"] > 0, name
        assert c["t_compute_ms"] > 0 and c["t_memory_ms"] > 0, name


def test_chip_smoke_roofline_lines(smoke, reduced_counts):
    """A line per step with both shares; a step timed faster than its
    counted FLOP time fails the run, a byte share above 1 does not."""
    counts = {k: v for k, v in reduced_counts.items() if k != "seconds"}
    # measured at twice the counted FLOP time, and half the memory term
    measured = {k: max(2 * c["t_compute_ms"], c["t_memory_ms"] / 2)
                for k, c in counts.items()}
    lines = smoke.roofline_lines(counts, measured)
    assert len(lines) == len(counts)
    for line in lines:
        assert line.startswith("[roofline] step=")
        kv = dict(re.findall(r"(\w+)=(\S+)", line))
        assert float(kv["flop_share"]) <= 0.5 + 1e-4
        assert "byte_share" in kv and "counted_flops" in kv
    fast = dict(measured)
    name = next(iter(fast))
    fast[name] = counts[name]["t_compute_ms"] / 1.1
    with pytest.raises(AssertionError, match="beats its counted FLOP"):
        smoke.roofline_lines(counts, fast)


def test_chip_smoke_measured_keys(smoke, reduced_counts):
    """``roofline_measured`` reads each counted step's time from the
    phases' records, under the names the counts use."""
    acorn_ms = {smoke.acorn_key(s, o, c): 1.0
                for s, o, c in smoke.ROOFLINE_ACORN}
    lm = {a: {"train_4k": {"step_p50_ms": 2.0},
              "prefill_32k": {"ms": 3.0}} for a in smoke.LM_ARCHES}
    got = smoke.roofline_measured(acorn_ms, {"two_tower": {
        "step_p50_ms": 4.0}}, lm)
    assert sorted(got) == sorted(k for k in reduced_counts
                                 if k != "seconds")
