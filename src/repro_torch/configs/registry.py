"""--arch registry: the 10 architectures of the JAX package's registry
(``src/repro/configs/registry.py``)."""

from __future__ import annotations

from typing import Dict

from .base import ArchSpec
from .gnn_family import GNN_SPECS
from .lm_family import LM_SPECS
from .recsys_family import RECSYS_SPECS

ARCHS: Dict[str, ArchSpec] = {}
ARCHS.update(LM_SPECS)
ARCHS.update(GNN_SPECS)
ARCHS.update(RECSYS_SPECS)


def get_arch(name: str) -> ArchSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every (arch, shape) dry-run cell — the 40-cell matrix."""
    out = []
    for name, spec in ARCHS.items():
        for shape_name, cell in spec.cells(spec.config).items():
            out.append((name, shape_name, cell))
    return out
