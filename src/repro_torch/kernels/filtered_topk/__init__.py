from .kernel import filtered_topk_cuda
from .merge import bounded_sorted_merge, bounded_sorted_merge_ref
from .ops import filtered_topk
from .ref import filtered_topk_ref

__all__ = ["bounded_sorted_merge", "bounded_sorted_merge_ref",
           "filtered_topk", "filtered_topk_cuda", "filtered_topk_ref"]
