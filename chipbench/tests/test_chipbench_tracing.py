"""The reductions of a traced segment, on hand-made events."""
import pytest
import torch

from chipbench import peaks, tracing


def seg():
    s = tracing.Segment(seconds=10e-6 * 10, stacks=True)
    # device ops (us): busy 0-10, 5-15 (overlap), 30-40, 70-80
    s.device = [("k_a", 0, 10), ("gather_distance_kernel", 5, 15),
                ("k_a", 30, 40), ("k_b", 70, 80)]
    s.frames = [(0, 29, "/x/repro_torch/core/search.py(268): _search_impl"),
                (12, 14, "/x/repro_torch/core/plan.py(600): evaluate_program"),
                (35, 90, "/x/repro_torch/core/search.py(161): _greedy_level"),
                (40, 60, "/x/repro_torch/core/plan.py(600): evaluate_program")]
    s.launched = [(("x/repro_torch/core/plan.py(600): evaluate_program",),
                   2e-6),
                  (("x/repro_torch/core/search.py(1): f",), 5e-6)]
    return s


def test_busy_and_kernels():
    s = seg()
    assert s.busy_s == pytest.approx(35e-6)
    assert s.kernel_seconds(lambda n: "gather" in n) == pytest.approx(10e-6)
    assert s.device_ops()[0] == ("k_a", pytest.approx(20e-6))


def test_idle_gaps_by_the_program_frame_running_then():
    gaps = dict(seg().idle_gaps())
    # 15-30 us begins inside _search_impl, 40-70 inside evaluate_program
    # under _greedy_level
    assert gaps == {
        "repro_torch/core/search.py(268): _search_impl": pytest.approx(15e-6),
        "repro_torch/core/plan.py(600): evaluate_program":
            pytest.approx(30e-6)}
    s = seg()
    s.frames = []
    assert dict(s.idle_gaps()) == {
        "outside the program": pytest.approx(45e-6)}


def test_device_time_under_a_frame():
    s = seg()
    assert s.under(lambda f: "core/plan.py" in f) == pytest.approx(2e-6)
    s.stacks = False
    assert s.under(lambda f: True) is None


def test_launches_belong_to_the_frames_running_then():
    frames = [(0, 100, "a"), (10, 20, "b"), (30, 60, "c"), (40, 50, "d"),
              (70, 80, "e")]
    got = tracing.enclosing(frames, [(15, 1.0), (45, 2.0), (55, 3.0),
                                     (65, 4.0), (75, 5.0), (120, 6.0)])
    assert got == [(("a", "b"), 1.0), (("a", "c", "d"), 2.0),
                   (("a", "c"), 3.0), (("a",), 4.0), (("a", "e"), 5.0),
                   ((), 6.0)]


def test_roofline_arithmetic():
    f, b = peaks.gather_distance_cost(1000, 128)
    assert b == 1000 * (4 * 128 + 8) and f == 3 * 1000 * 128
    f, b = peaks.prefilter_cost(64, 64 * 11000, 2**20, 512, 10)
    assert peaks.bound_seconds(f, b) == pytest.approx(b / 3.35e12)
    assert peaks.roofline_percent(1.0, 4.0) == 25.0
    assert peaks.roofline_percent(1.0, 0.0) is None


def test_segment_on_the_cpu():
    """The profiler path runs end to end here (no device events)."""
    def work():
        a = torch.randn(64)
        for _ in range(20):
            a = torch.where(a > 0, a, -a) + 1
    s = tracing.run_segment(work, stacks=True, cuda=False)
    assert s.seconds > 0 and s.device == [] and s.py_events > 0


def test_trace_events_place_every_launch():
    """Launches by an aten op and by a ``ctypes`` call (no aten op around
    it) both count under the program frame running at their runtime
    call; device operations with no call are counted as unplaced."""
    ev = [
        {"ph": "X", "cat": "python_function", "ts": 0, "dur": 100,
         "name": "/r/src/repro_torch/core/index.py(133): prefilter"},
        {"ph": "X", "cat": "python_function", "ts": 10, "dur": 20,
         "name": "/r/src/repro_torch/core/bruteforce.py(69): masked_topk"},
        {"ph": "X", "cat": "python_function", "ts": 40, "dur": 20,
         "name": "/r/src/repro_torch/kernels/filtered_topk/kernel.py(47):"
                 " filtered_topk_cuda"},
        {"ph": "X", "cat": "python_function", "ts": 0, "dur": 200,
         "name": "chipbench/harness.py(160): serve"},
        {"ph": "X", "cat": "cpu_op", "ts": 11, "dur": 5, "name": "aten::mm"},
        {"ph": "X", "cat": "cuda_runtime", "ts": 12, "dur": 2,
         "name": "cudaLaunchKernel", "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "ts": 45, "dur": 2,
         "name": "cudaLaunchKernel", "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_driver", "ts": 150, "dur": 2,
         "name": "cuLaunchKernel", "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "ts": 20, "dur": 3, "name": "gemm",
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "ts": 50, "dur": 4, "name": "topk",
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memset", "ts": 160, "dur": 1, "name": "set",
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "ts": 170, "dur": 1, "name": "lost",
         "args": {"correlation": 10}},
        {"ph": "i", "cat": "kernel", "ts": 0, "name": "marker"},
    ]
    s = tracing.Segment(seconds=1.0, stacks=True)
    tracing.read_trace(s, ev)
    assert s.py_events == 4 and len(s.frames) == 3 and s.unplaced == 1
    assert len(s.device) == 4
    assert s.under(lambda f: f.endswith(": prefilter")) == pytest.approx(7e-6)
    assert s.under(lambda f: "filtered_topk" in f) == pytest.approx(4e-6)
    assert s.under(lambda f: "bruteforce" in f) == pytest.approx(3e-6)
