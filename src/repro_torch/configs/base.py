"""ArchSpec: the interface every architecture of the port implements
(``src/repro/configs/base.py``).

An ArchSpec knows how to
  * give its full config (the published scale) and a reduced smoke config,
  * build its model: initialised from a ``torch.Generator``
    (``init_fn``), uninitialised (``build_fn``), or on the meta device
    with no memory and no draw (``abstract_params``),
  * give its loss and serve functions,
  * describe each of its shape cells by the shapes and dtypes of the
    cell's model inputs (``cells``, as meta tensors: the counterpart of
    the reference's ``ShapeDtypeStruct``s), and whether the cell runs a
    train step or a serving step,
  * make small concrete batches for smoke tests (``smoke_batch``, numpy,
    the reference's bit for bit).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

f32 = torch.float32
bf16 = torch.bfloat16
i32 = torch.int32


def sds(shape, dtype=f32) -> torch.Tensor:
    """A shape and dtype without data: a tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class Cell:
    """One (arch × input-shape) dry-run cell."""
    shape_name: str
    kind: str                     # "train" | "serve"
    batch_specs: Dict[str, Any]   # name -> meta tensor (model inputs)
    note: str = ""


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                   # "lm" | "gnn" | "recsys"
    config: Any                   # full config
    smoke_config: Any             # reduced config
    init_fn: Callable             # (cfg, generator, device) -> module
    build_fn: Callable            # (cfg, device) -> module, uninitialised
    loss_fn: Callable             # (model, cfg, batch) -> scalar
    serve_fn: Optional[Callable]  # (model, cfg, batch) -> outputs
    cells: Callable               # (cfg) -> Dict[shape_name, Cell]
    smoke_batch: Callable         # (cfg, kind, seed) -> numpy batch dict
    # decode-style serving needs a cache spec builder
    cache_spec: Optional[Callable] = None   # (cfg, batch, seq) -> meta dict

    def abstract_params(self, cfg=None) -> torch.nn.Module:
        """The model of ``cfg`` (default: the full config) on the meta
        device: every parameter's shape and dtype, no memory, no draw."""
        return self.build_fn(cfg or self.config, torch.device("meta"))
