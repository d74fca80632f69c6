"""The card's peaks and the operations and bytes each measured kernel
needs, frozen for the benchmark.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense rates, at the full 700 W
power limit (copied from ``src/repro_torch/launch/roofline.py``, commit
041aa84): fp32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.  A
card set below 700 W reads a lower share; the run prints the card's
power limit beside the shares.

A roofline share is the least time the card could take for the work (the
larger of operations over the fp32 peak and bytes over the HBM rate)
over the device time measured, in percent.  Bytes count each input byte
read once and each output byte written once, for the work these inputs
need.
"""
from __future__ import annotations

PEAK_FP32_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM5 data sheet, 700 W: fp32 67 TFLOP/s, HBM3 3.35 TB/s"


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time for ``flops`` fp32 operations moving ``nbytes``."""
    return max(flops / PEAK_FP32_PER_S, nbytes / HBM_BYTES_PER_S)


def roofline_percent(bound_s: float, measured_s: float):
    """The share of the roofline in percent; None where nothing was
    measured."""
    if measured_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / measured_s


def gather_distance_cost(dist_comps: int, d: int):
    """(flops, bytes) of the fresh distances a search computed: each
    scored row of ``d`` float32 read once, its int32 id read and its
    float32 distance written once; 3 flops a row element (a subtract, a
    multiply, an add).  The form of ``kernels/cost.py::
    gather_distance_cost`` (commit 041aa84) with every counted distance a
    distinct row, and without the queries and the padded slots, which
    this count does not see: a lower bound."""
    return 3.0 * dist_comps * d, float(dist_comps) * (4 * d + 8)


def prefilter_cost(queries: int, pairs: int, n: int, d: int, k: int):
    """(flops, bytes) of an exact pre-filter over ``queries`` queries with
    ``pairs`` passing (query, row) pairs in all: 2 d flops a passing
    pair; the corpus (n x d float32) read once, a mask byte a query and
    row, the queries and the (ids, dists) answers.  Whatever implements
    the route needs this."""
    return (2.0 * d * pairs,
            4.0 * n * d + queries * n + 4.0 * queries * d + 8.0 * queries * k)
