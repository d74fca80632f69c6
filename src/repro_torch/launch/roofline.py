"""Roofline terms of one rank's step on an NVIDIA H100 SXM (the twin of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds, from the counts of
:mod:`repro_torch.launch.op_cost` (per rank):

  compute    = sum over dtype classes of FLOPs / that class's peak
  memory     = bytes            / HBM bandwidth
  collective = collective bytes / link bandwidth

The reference keeps one FLOP count at the TPU's bf16 peak.  An H100's
tensor cores run bf16 / fp16 at 15x its fp32 rate, and the port keeps TF32
off, so FLOPs are kept by dtype class: bf16 / fp16 at the dense bf16
peak, fp32 at the fp32 (non-tensor) peak, and everything else (integer,
bool, float64) timed at the fp32 peak too.

Hardware constants, the H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data
sheet; NVIDIA DGX H100 data sheet for the network):

  * ``PEAK_BF16_PER_S``: 989 TFLOP/s, dense bf16 / fp16 tensor cores;
  * ``PEAK_FP32_PER_S``: 67 TFLOP/s, fp32 without TF32;
  * ``HBM_BYTES_PER_S``: 3.35 TB/s of HBM3;
  * ``LINK_BYTES_PER_S``: 50 GB/s per GPU, one NDR 400 Gb/s InfiniBand
    port per GPU in a DGX H100 pod.  A 16 x 16 mesh spans 32 nodes of
    eight GPUs, so most of a mesh axis's traffic leaves the node;
  * ``NVLINK_BYTES_PER_S``: 450 GB/s per direction between the eight GPUs
    of one node (900 GB/s both ways), named for the reader; the
    collective term does not use it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

PEAK_BF16_PER_S = 989e12
PEAK_FP32_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
LINK_BYTES_PER_S = 50e9
NVLINK_BYTES_PER_S = 450e9

# a timed step may not beat its counted FLOPs at the card's peaks by more
# (the counter overcounts, or a peak is wrong)
ROOFLINE_FLOP_SHARE_MAX = 1.05

# dtype class -> the peak its FLOPs are timed at
PEAKS = {"bf16": PEAK_BF16_PER_S, "fp32": PEAK_FP32_PER_S,
         "other": PEAK_FP32_PER_S}


@dataclass
class Roofline:
    flops: Dict[str, float]      # per rank, by dtype class (PEAKS' keys)
    bytes_accessed: float        # per rank
    collective_bytes: float      # per rank
    collectives: Dict = field(default_factory=dict)
    model_flops: Optional[float] = None  # 6·N·D (train) / 2·N·D, global

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def t_compute_by_dtype(self) -> Dict[str, float]:
        return {k: self.flops.get(k, 0.0) / peak for k, peak in PEAKS.items()}

    @property
    def t_compute(self) -> float:
        return sum(self.t_compute_by_dtype.values())

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def useful_flops_ratio(self, chips: int) -> Optional[float]:
        """MODEL_FLOPS / (counted FLOPs · chips): how much of the counted
        compute is useful; catches recompute and replicated compute."""
        if self.model_flops is None or self.total_flops == 0:
            return None
        return self.model_flops / (self.total_flops * chips)

    def to_dict(self, chips: int) -> Dict:
        """The reference's keys, plus the dtype split and ``t_bound``."""
        return dict(
            flops_per_chip=self.total_flops,
            bytes_per_chip=self.bytes_accessed,
            collective_bytes_per_chip=self.collective_bytes,
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            model_flops=self.model_flops,
            useful_flops_ratio=self.useful_flops_ratio(chips),
            collectives=self.collectives,
            flops_by_dtype=dict(self.flops),
            t_compute_by_dtype=self.t_compute_by_dtype,
            t_bound=self.t_bound,
        )


def analyze(counter, model_flops: Optional[float] = None) -> Roofline:
    """The roofline of what an :class:`~repro_torch.launch.op_cost.OpCounter`
    counted (one rank's step)."""
    return Roofline(flops=dict(counter.flops),
                    bytes_accessed=counter.bytes,
                    collective_bytes=counter.coll_bytes,
                    collectives={k: dict(v) for k, v in counter.coll.items()},
                    model_flops=model_flops)
