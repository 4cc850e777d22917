from .kernel import embedding_bag, embedding_bag_backward
from .ops import embedding_bag_padded, pad_ragged
from .ref import (PIECE, embedding_bag_backward_ref,
                  embedding_bag_backward_sorted_ref, embedding_bag_padded_ref,
                  embedding_bag_ref, take)

__all__ = ["PIECE", "embedding_bag", "embedding_bag_backward",
           "embedding_bag_backward_ref", "embedding_bag_backward_sorted_ref",
           "embedding_bag_padded", "embedding_bag_padded_ref",
           "embedding_bag_ref", "pad_ragged", "take"]
