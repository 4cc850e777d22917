"""repro_torch.dist — sharded, replicated serving of the annotative index.

  shard_router  ShardedWarren: hash-partitioned index serving with a
                versioned RoutingTable (address ranges + routing epochs)
  rebalance     live shard rebalancing: split/merge replica groups by
                streaming segments, without pausing writers
  parallel      ScatterGather worker pool + serving time breakdown
  checkpoint    index and routing snapshots (the train-state half comes
                with the training port)

Submodules are imported lazily, so pulling in one never drags the whole
index stack along.
"""

import importlib

_SUBMODULES = ("checkpoint", "shard_router", "parallel", "rebalance")

_LAZY_NAMES = {
    "ShardedWarren": "shard_router",
    "RoutingTable": "shard_router",
    "CheckpointManager": "checkpoint",
    "ScatterGather": "parallel",
    "ScatterTimings": "parallel",
    "Rebalancer": "rebalance",
    "RebalanceStats": "rebalance",
}

__all__ = list(_SUBMODULES) + list(_LAZY_NAMES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY_NAMES:
        mod = importlib.import_module(f".{_LAZY_NAMES[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
