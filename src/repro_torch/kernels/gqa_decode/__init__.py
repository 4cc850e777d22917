from .kernel import gqa_decode
from .ref import gqa_decode_ref

__all__ = ["gqa_decode", "gqa_decode_ref"]
