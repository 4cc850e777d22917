"""Crash fault-point seam for the durable storage paths.

Every durability-critical boundary (block-run write, manifest publish,
sliced-run shipping) announces itself through :func:`fault_point` before
and/or after its fsync/rename.  In production the hook is ``None`` and the
call is one attribute load; the crash-injection test matrix
(``tests/test_tiered_crash.py``) installs a hook that raises at the k-th
announcement, simulating a process kill at exactly that boundary, then
reopens the store from disk and checks latest-good recovery.

The seam is deliberately tiny and process-global: fault names are plain
strings (``"run.synced"``, ``"manifest.published"``, ...) so the matrix can
enumerate every boundary a scenario crosses by counting one clean pass.
"""

from __future__ import annotations

from typing import Callable, Optional

_hook: Optional[Callable[[str], None]] = None


class InjectedCrash(Exception):
    """Raised by a test hook to simulate a process kill at a fault point."""

    def __init__(self, name: str, ordinal: int):
        super().__init__(f"injected crash at fault point {ordinal}: {name}")
        self.name = name
        self.ordinal = ordinal


def set_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the process-global fault hook."""
    global _hook
    _hook = hook


def fault_point(name: str) -> None:
    """Announce a durability boundary; a no-op unless a hook is installed."""
    if _hook is not None:
        _hook(name)
