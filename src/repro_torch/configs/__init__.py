"""Model configurations of the port: the LM, GNN and recsys families and
the ``ArchSpec`` registry over them."""

from .base import ArchSpec, Cell
from .registry import ARCHS, all_cells, get_arch

__all__ = ["ArchSpec", "Cell", "ARCHS", "all_cells", "get_arch"]
