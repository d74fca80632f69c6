from .kernel import neighbor_expand_cuda
from .ops import neighbor_expand
from .ref import (expansion_candidates, first_m_true_batched,
                  first_occurrence_mask, neighbor_expand_argsort,
                  neighbor_expand_ref, use_scatter_dedup)

__all__ = [
    "neighbor_expand", "neighbor_expand_cuda", "neighbor_expand_ref",
    "neighbor_expand_argsort", "expansion_candidates",
    "first_occurrence_mask", "first_m_true_batched", "use_scatter_dedup",
]
