from .kernel import interval_join
from .ref import contained_in_mask_ref, containing_mask_ref

__all__ = ["interval_join", "contained_in_mask_ref", "containing_mask_ref"]
