"""Annotative index core: the host side of ranked and structured retrieval.

Host logic is kept identical to the reference package's, so the same
documents yield the same addresses, feature ids and float64 impacts.
"""

from .annotation import (INF, NINF, Annotation, AnnotationList, merge_lists,
                         reduce_minimal, union_intervals)
from .featurizer import (HashingFeaturizer, JsonFeaturizer, VocabFeaturizer,
                         murmur64a)
from .gcl import (BothOf, ContainedIn, Containing, FollowedBy, GCLNode,
                  NotContainedIn, NotContaining, OneOf, Phrase, Term,
                  both_of_all, one_of_all)
from .graph_store import GraphStore
from .index import DynamicIndex, Segment, Snapshot, Transaction
from .json_store import add_json, annotate_dates, render_tokens, value_of
from .query import parse_query, solve
from .ranking import (CollectionStats, average_precision, build_block_impacts,
                      collection_stats, expand_query, index_document,
                      ingest_documents, score_blockmax, score_bm25,
                      score_wand)
from .sparse import index_sparse_vector, score_hybrid, score_sparse
from .static import StaticIndex, merge_runs, write_run, write_static
from .stemmer import porter_stem
from .tokenizer import AsciiTokenizer, Utf8Tokenizer
from .warren import Warren

__all__ = [
    "INF", "NINF", "Annotation", "AnnotationList", "merge_lists",
    "reduce_minimal", "union_intervals", "HashingFeaturizer",
    "JsonFeaturizer", "VocabFeaturizer", "murmur64a", "BothOf", "ContainedIn",
    "Containing", "FollowedBy", "GCLNode", "NotContainedIn", "NotContaining",
    "OneOf", "Phrase", "Term", "both_of_all", "one_of_all", "GraphStore",
    "DynamicIndex",
    "Segment", "Snapshot", "Transaction", "add_json", "annotate_dates",
    "render_tokens", "value_of", "parse_query", "solve",
    "CollectionStats", "average_precision", "build_block_impacts",
    "collection_stats", "expand_query", "index_document", "ingest_documents",
    "score_blockmax", "score_bm25", "score_wand", "index_sparse_vector",
    "score_hybrid", "score_sparse",
    "StaticIndex", "merge_runs", "write_run", "write_static",
    "porter_stem", "AsciiTokenizer", "Utf8Tokenizer", "Warren",
]
