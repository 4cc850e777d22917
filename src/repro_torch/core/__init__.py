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
from .index import DynamicIndex, Segment, Snapshot, Transaction
from .json_store import add_json, annotate_dates, render_tokens, value_of
from .query import parse_query, solve
from .ranking import (CollectionStats, build_block_impacts, collection_stats,
                      index_document, ingest_documents, score_blockmax,
                      score_bm25)
from .stemmer import porter_stem
from .tokenizer import AsciiTokenizer, Utf8Tokenizer
from .warren import Warren

__all__ = [
    "INF", "NINF", "Annotation", "AnnotationList", "merge_lists",
    "reduce_minimal", "union_intervals", "HashingFeaturizer",
    "JsonFeaturizer", "VocabFeaturizer", "murmur64a", "BothOf", "ContainedIn",
    "Containing", "FollowedBy", "GCLNode", "NotContainedIn", "NotContaining",
    "OneOf", "Phrase", "Term", "both_of_all", "one_of_all", "DynamicIndex",
    "Segment", "Snapshot", "Transaction", "add_json", "annotate_dates",
    "render_tokens", "value_of", "parse_query", "solve",
    "CollectionStats", "build_block_impacts", "collection_stats",
    "index_document", "ingest_documents", "score_blockmax", "score_bm25",
    "porter_stem", "AsciiTokenizer", "Utf8Tokenizer", "Warren",
]
