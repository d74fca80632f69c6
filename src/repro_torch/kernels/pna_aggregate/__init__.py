from .kernel import pna_aggregate_cuda
from .ops import pna_aggregate, pna_aggregate_segment
from .ref import pna_aggregate_ref, pna_aggregate_segment_ref

__all__ = ["pna_aggregate", "pna_aggregate_cuda", "pna_aggregate_ref",
           "pna_aggregate_segment", "pna_aggregate_segment_ref"]
