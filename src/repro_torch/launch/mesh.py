"""Production meshes on ``torch.distributed``'s ``DeviceMesh``
(``src/repro/launch/mesh.py``), and the two ways the port sets up the
process group under them.

The mesh functions are FUNCTIONS over the process group already
initialised, so importing this module initialises nothing.  Their default
device type is the card's; the tests and the dry run on CPU fakes pass
``device_type="cpu"``.

Process groups (nothing on the machine tells a program of a cluster, so
each helper names its own store):

* :func:`fake_process_group` — ``world_size`` ranks of PyTorch's fake
  backend, seen from ``rank``: collectives do nothing and move nothing, so
  one process can trace a step on the 256- or 512-device production mesh
  (the dry run);
* :func:`file_process_group` — a real group (``gloo`` on the CPU, ``nccl``
  on the card) over a ``file://`` store: no network, no ``MASTER_ADDR``.
  One rank by default, in a temporary directory; the multi-process tests
  give every rank the same ``init_file``.

Both are context managers that destroy the group on exit, so no group
outlives the test or phase that made it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, Iterator, Optional

import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_local_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """``("data", "model")`` over the process group's ranks, with
    ``min(model_parallel, world size)`` on ``model``."""
    n = dist.get_world_size()
    mp = min(model_parallel, n)
    return _mesh(device_type, (n // mp, mp), ("data", "model"))


def make_mesh_from_sizes(sizes: Dict[str, int], device_type: str = "cuda"):
    """A mesh from an ``{axis: size}`` dict, axes in the dict's order (the
    elastic restart: feed it :func:`repro_torch.dist.elastic.shrink_mesh`'s
    output after losing devices)."""
    axes = tuple(sizes)
    return _mesh(device_type, tuple(sizes[a] for a in axes), axes)


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """``world_size`` ranks of the fake backend, this process as ``rank``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _refuse_second_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def file_process_group(backend: str, world_size: int = 1, rank: int = 0,
                       init_file: Optional[str] = None) -> Iterator[None]:
    """A real ``backend`` group over a ``file://`` store: ``init_file``
    (shared by every rank; it must not exist before the first rank comes)
    or, by default, a file in a new temporary directory."""
    _refuse_second_group()
    with contextlib.ExitStack() as stack:
        if init_file is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            init_file = os.path.join(tmp, "store")
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _refuse_second_group() -> None:
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process")
