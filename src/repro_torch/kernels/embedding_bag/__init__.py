from .kernel import embedding_bag_cuda
from .ops import embedding_bag
from .ref import embedding_bag_ref, embedding_bag_segment_ref

__all__ = ["embedding_bag", "embedding_bag_cuda", "embedding_bag_ref",
           "embedding_bag_segment_ref"]
