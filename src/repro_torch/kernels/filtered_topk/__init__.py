from .merge import bounded_sorted_merge, bounded_sorted_merge_ref

__all__ = ["bounded_sorted_merge", "bounded_sorted_merge_ref"]
