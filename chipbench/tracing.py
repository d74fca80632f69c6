"""Traced segments of a run, reduced to what the per-layer readers need.

Two segments follow the measured window, each over requests of their
own: a plain one (``torch.profiler`` on the host and the card, no Python
stacks) for the device's busy time, the kernels' time by name and the
breakdown; and one that records the Python functions, whose host is
slower, for the device time launched while a given function of the
program ran and for labelling the idle gaps by what the host was
running.

A device operation belongs to the Python functions of the program that
were running on the host when it was launched: the host launch call of
the same correlation id (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ...) gives the moment, and the program's Python
function events that span that moment give the frames.  So a kernel
counts the same whether an aten op or a ``ctypes`` call launched it.
Both come from the profiler's exported trace, which holds the Python
function events in every version (``prof.events()`` drops them in some).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

US = 1e-6
# frames of the program under test, for labelling idle gaps and for
# attributing device time
PROGRAM_MARK = "repro_torch/"
# categories of the exported trace: operations on the device, host calls
# of the CUDA runtime and driver (launches, copies, sets), Python calls
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
PYTHON_CAT = "python_function"


@dataclass
class Segment:
    seconds: float                       # host time of the segment
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    # (program frames running at the launch, device seconds) a device op
    launched: List[Tuple[Tuple[str, ...], float]] = field(default_factory=list)
    # device ops whose launch the trace did not place on the host
    unplaced: int = 0
    # Python function events recorded, and (start, end, name) of those
    # of the program
    py_events: int = 0
    frames: List[Tuple[float, float, str]] = field(default_factory=list)
    stacks: bool = False
    # the port's kernel launches during the segment, by launcher
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if e > end:
                total += e - max(s, end)
                end = e
        return total * US

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for name, s, e in self.device if match(name)) * US

    def under(self, match: Callable[[str], bool]) -> Optional[float]:
        """Device seconds of the operations launched while a program
        function that ``match``es was running; None where no stack was
        recorded."""
        if not self.stacks or not self.launched:
            return None
        return sum(sec for st, sec in self.launched
                   if any(match(f) for f in st))

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name] += (e - s) * US
        return sorted(by.items(), key=lambda t: -t[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """Idle time between device operations, summed by the innermost
        program function running on the host when the gap began."""
        ivs = sorted((s, e) for _, s, e in self.device)
        if not ivs:
            return []
        merged = [list(ivs[0])]
        for s, e in ivs[1:]:
            if s > merged[-1][1]:
                merged.append([s, e])
            else:
                merged[-1][1] = max(merged[-1][1], e)
        gaps = [(e0, (s1 - e0) * US)
                for (_, e0), (s1, _) in zip(merged, merged[1:])]
        by = defaultdict(float)
        for names, sec in enclosing(self.frames, gaps):
            by[_label(names[-1]) if names else "outside the program"] += sec
        return sorted(by.items(), key=lambda t: -t[1])[:top]


def _label(name: str) -> str:
    """A frame's name from the program's package on."""
    name = name.replace("\\", "/")
    return name[name.find(PROGRAM_MARK):]


def run_segment(fn: Callable[[], None], stacks: bool, cuda: bool) -> Segment:
    """Run ``fn`` (which ends with a synchronise) under the profiler."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kw = {}
    if stacks:
        from torch._C._profiler import _ExperimentalConfig
        kw = dict(with_stack=True,
                  experimental_config=_ExperimentalConfig(verbose=True))
    with profile(activities=acts, **kw) as prof:
        t0 = time.perf_counter()
        fn()
        seconds = time.perf_counter() - t0
    seg = Segment(seconds=seconds, stacks=stacks)
    if not stacks:
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                seg.device.append((ev.name, ev.time_range.start,
                                   ev.time_range.end))
        return seg
    fd, path = tempfile.mkstemp(suffix=".json")    # under TMPDIR
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    read_trace(seg, events)
    return seg


def read_trace(seg: Segment, events: List[dict]) -> None:
    """Fill ``seg`` from the events of an exported trace (times in us)."""
    calls = {}          # runtime call's correlation id -> host time
    kernels = []        # (correlation id, seconds)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            seg.device.append((e["name"], start, end))
            kernels.append((corr, (end - start) * US))
        elif cat in RUNTIME_CATS:
            calls[corr] = start
        elif cat == PYTHON_CAT:
            seg.py_events += 1
            if PROGRAM_MARK in e["name"].replace("\\", "/"):
                seg.frames.append((start, end, e["name"]))
    placed = []
    for corr, sec in kernels:
        if corr in calls:
            placed.append((calls[corr], sec))
        else:
            seg.unplaced += 1
    seg.launched = enclosing(seg.frames, placed)


def enclosing(frames: List[Tuple[float, float, str]],
              points: List[Tuple[float, float]]
              ) -> List[Tuple[Tuple[str, ...], float]]:
    """For each (time, value) point, the names of the ``frames`` (start,
    end, name: the nested calls of one thread) that span it, outermost
    first."""
    frames = sorted(frames, key=lambda f: (f[0], -f[1]))
    out, open_, j = [], [], 0
    for t, value in sorted(points):
        while j < len(frames) and frames[j][0] <= t:
            while open_ and open_[-1][1] < frames[j][0]:
                open_.pop()
            open_.append(frames[j])
            j += 1
        while open_ and open_[-1][1] < t:
            open_.pop()
        out.append((tuple(f[2] for f in open_), value))
    return out


def launch_counters() -> Dict[str, int]:
    """The port's per-kernel launch counters (``<launcher>.launches``)."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels
    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        if not info.ispkg:
            continue
        try:
            mod = importlib.import_module(f"repro_torch.kernels.{info.name}.kernel")
        except ModuleNotFoundError:
            continue
        for name, obj in vars(mod).items():
            if callable(obj) and hasattr(obj, "launches"):
                out[name] = int(obj.launches)
    return out
