from .kernel import gather_distance_cuda
from .ops import gather_distance
from .ref import gather_distance_ref

__all__ = ["gather_distance", "gather_distance_cuda", "gather_distance_ref"]
