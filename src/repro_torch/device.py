"""Device selection: entry points run on the card unless asked for the CPU;
and device-resident scalars made once."""

import functools

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


_sm_count = {}


def sm_count(device: torch.device) -> int:
    """The CUDA card's streaming multiprocessors, read once a card."""
    dev = device.index if device.index is not None else \
        torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_count[dev]


def scalar(x: float, device: torch.device) -> torch.Tensor:
    """The float32 scalar ``x`` on ``device``, made once per (value,
    device) and never written: a tensor made from a Python number on every
    step would be copied to the card each time, and PyTorch waits for
    that copy (a host sync).  Under a ``FakeTensorMode`` (a dry run) it is
    made anew each time: a fake kept in the cache would reach a real step
    later, and a real one would enter the fake step."""
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return _scalar(x, device)


@functools.lru_cache(maxsize=None)
def _scalar(x: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)
