"""Plain PyTorch version of the containment join: one batched
``searchsorted`` probe per element of A, as the reference's ``ref.py``.

For a GC-list B (valid starts and ends strictly increasing, PAD entries at
the tail) the first B ending at or after A[i]'s end is the only candidate
container of A[i], and the first B starting at or after A[i]'s start the
only candidate it contains, so one probe gives the dense definition.
"""

import torch

from repro_torch.core.vectorized import PAD

_PAD = int(PAD)


def _probe(a_s, a_e, b_s, b_e, by_end: bool):
    if b_s.numel() == 0:
        return torch.zeros_like(a_s, dtype=torch.int32)
    key, bkey = (a_e, b_e) if by_end else (a_s, b_s)
    j = torch.searchsorted(bkey, key, side="left").clamp_(
        max=b_s.shape[0] - 1)
    if by_end:      # contained in: b_s ≤ a_s ∧ a_e ≤ b_e
        ok = (b_e[j] >= a_e) & (b_s[j] <= a_s)
    else:           # containing: a_s ≤ b_s ∧ b_e ≤ a_e
        ok = (b_s[j] >= a_s) & (b_e[j] <= a_e)
    return (ok & (b_s[j] != _PAD) & (a_s != _PAD)).to(torch.int32)


def contained_in_mask_ref(a_s, a_e, b_s, b_e):
    """int32 mask[i] = A[i] ⊑ some B[j]."""
    return _probe(a_s, a_e, b_s, b_e, by_end=True)


def containing_mask_ref(a_s, a_e, b_s, b_e):
    """int32 mask[i] = A[i] ⊒ some B[j]."""
    return _probe(a_s, a_e, b_s, b_e, by_end=False)


MODES = {"contained_in": contained_in_mask_ref,
         "containing": containing_mask_ref}
