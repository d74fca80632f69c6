"""Distributed execution of the port.  So far only the deterministic
cross-shard top-k merge; the mesh collectives, query- and corpus-parallel
dispatch wait for ``ROADMAP.md`` queue 1 item 3."""
from .collectives import merge_topk

__all__ = ["merge_topk"]
