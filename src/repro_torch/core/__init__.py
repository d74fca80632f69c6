"""ACORN core: predicate-agnostic hybrid search over vectors + structured
data, in PyTorch."""
from .predicates import (AttributeTable, Predicate, Equals, OneOf, Between,
                         ContainsAny, RegexMatch, And, Or, Not, TruePredicate,
                         SelectivitySketch, evaluate, evaluate_batch,
                         selectivity, pack_multihot, keywords_to_bitset)
from .plan import (ExecutionSpec, PredicateProgram, SearchRequest,
                   SearchResult, TableSchema, PackedColumns, admission_key,
                   compile_predicates, evaluate_predicates, evaluate_program,
                   pack_columns, regex_aux, resolve_execution_spec,
                   sentinel_result)
from .graph import (LayeredGraph, assign_levels, average_out_degree,
                    level_constant, memory_bytes, neighbor_rows)
from .bruteforce import masked_topk, ground_truth, recall_at_k, pairwise_sq_l2
from .build import (acorn_compress, build_acorn_1, build_acorn_gamma,
                    build_bulk, build_hnsw, knn_among, reverse_slack,
                    rng_prune, with_reverse_slack)
from .search import (SearchStats, ann_search, dedup_mask, first_m_true,
                     get_neighbors, hybrid_search, hybrid_search_sharded)
from .batched import (DEFAULT_BUCKETS, VariantCache, bucket_for,
                      coalesce_take, mesh_buckets, pad_rows, plan_chunks,
                      search_batch)
from .baselines import (OraclePartitionIndex, postfilter_search,
                        prefilter_search)
from .index import AcornConfig, HybridIndex
from .correlation import min_dist, query_correlation

__all__ = [
    "AttributeTable", "Predicate", "Equals", "OneOf", "Between",
    "ContainsAny", "RegexMatch", "And", "Or", "Not", "TruePredicate",
    "SelectivitySketch", "evaluate", "evaluate_batch", "selectivity",
    "pack_multihot", "keywords_to_bitset",
    "ExecutionSpec", "PredicateProgram", "SearchRequest", "SearchResult",
    "TableSchema", "PackedColumns", "admission_key", "compile_predicates",
    "evaluate_predicates", "evaluate_program", "pack_columns", "regex_aux",
    "resolve_execution_spec", "sentinel_result",
    "LayeredGraph", "assign_levels", "average_out_degree", "level_constant",
    "memory_bytes", "neighbor_rows",
    "masked_topk", "ground_truth", "recall_at_k", "pairwise_sq_l2",
    "acorn_compress", "build_acorn_1", "build_acorn_gamma", "build_bulk",
    "build_hnsw", "knn_among", "reverse_slack", "rng_prune",
    "with_reverse_slack",
    "SearchStats", "ann_search", "dedup_mask", "first_m_true",
    "get_neighbors", "hybrid_search", "hybrid_search_sharded",
    "DEFAULT_BUCKETS", "VariantCache", "bucket_for", "coalesce_take",
    "mesh_buckets", "pad_rows", "plan_chunks", "search_batch",
    "prefilter_search", "postfilter_search", "OraclePartitionIndex",
    "AcornConfig", "HybridIndex",
    "min_dist", "query_correlation",
]
