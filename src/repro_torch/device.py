"""Device selection: entry points run on the card unless asked for the CPU."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Asking for CUDA without a card raises —
    there is no silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host")
    return dev
