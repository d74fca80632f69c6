"""Distributed execution on ``torch.distributed``: the device mesh,
collectives, query parallelism, corpus-sharded SPMD serving, and the
training mesh rules (``sharding.py``: each arch's partition specs, and
placing and running a step by them).  A mesh device is a rank of the
default process group (``collectives.py`` says how the reference's
single-controller ``shard_map`` maps onto ranks)."""
from repro_torch.core.batched import mesh_buckets

from .collectives import (Mesh, all_reduce, compressed_psum,
                          dequantize_int8, gathered_topk_merge, get_mesh,
                          make_sharded_lookup, merge_topk, quantize_int8,
                          sharded_topk, split_kv_decode_attention, top_k)
from .corpus_parallel import (ShardedCorpus, corpus_mesh, corpus_search_batch,
                              corpus_search_fn, resolve_corpus_mesh_shape,
                              shard_slice, stack_corpus, stack_regex_aux)
from .query_parallel import (data_mesh, local_device_count,
                             resolve_data_parallel, sharded_search_fn)
from .sharding import (AbstractMesh, P, gather, place, sharded_step,
                       tree_param_specs)

__all__ = [
    "AbstractMesh", "Mesh", "P", "ShardedCorpus", "all_reduce",
    "compressed_psum", "corpus_mesh", "corpus_search_batch",
    "corpus_search_fn", "data_mesh", "dequantize_int8", "gather",
    "gathered_topk_merge", "get_mesh", "local_device_count",
    "make_sharded_lookup", "merge_topk", "mesh_buckets", "place",
    "quantize_int8", "resolve_corpus_mesh_shape", "resolve_data_parallel",
    "shard_slice", "sharded_search_fn", "sharded_step", "sharded_topk",
    "split_kv_decode_attention", "stack_corpus", "stack_regex_aux", "top_k",
    "tree_param_specs",
]
