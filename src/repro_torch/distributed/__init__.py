"""Distributed execution on ``torch.distributed``: the device mesh,
collectives, query parallelism and corpus-sharded SPMD serving.  A mesh
device is a rank of the default process group (``collectives.py`` says
how the reference's single-controller ``shard_map`` maps onto ranks)."""
from repro_torch.core.batched import mesh_buckets

from .collectives import (Mesh, gathered_topk_merge, get_mesh, merge_topk,
                          sharded_topk, top_k)
from .corpus_parallel import (ShardedCorpus, corpus_mesh, corpus_search_batch,
                              corpus_search_fn, resolve_corpus_mesh_shape,
                              shard_slice, stack_corpus, stack_regex_aux)
from .query_parallel import (data_mesh, local_device_count,
                             resolve_data_parallel, sharded_search_fn)

__all__ = [
    "Mesh", "ShardedCorpus", "corpus_mesh", "corpus_search_batch",
    "corpus_search_fn", "data_mesh", "gathered_topk_merge", "get_mesh",
    "local_device_count", "merge_topk", "mesh_buckets",
    "resolve_corpus_mesh_shape", "resolve_data_parallel", "shard_slice",
    "sharded_search_fn", "sharded_topk", "stack_corpus", "stack_regex_aux",
    "top_k",
]
