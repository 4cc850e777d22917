"""repro_torch.dist — sharded, replicated serving of the annotative index,
and the training side's meshes.

  shard_router  ShardedWarren: hash-partitioned index serving with a
                versioned RoutingTable (address ranges + routing epochs)
  rebalance     live shard rebalancing: split/merge replica groups by
                streaming segments, without pausing writers
  parallel      ScatterGather worker pool + serving time breakdown
  checkpoint    index, routing and train-state snapshots
  compression   int8 error-feedback gradient compression, and the
                compressed mean over a mesh dimension (the pod axis)
  sharding      the production meshes' sharding policies as DTensor
                placements, and the kernel operators' DTensor rules
  on_mesh       what model code needs to run on DTensors (lookups,
                pinned layouts, gradients placed), no-ops off a mesh
  elastic       mesh shrink, repartition, live split/merge and reshard,
                and the autopilot started over a live warren
  autopilot     closed-loop control plane: Controller + policies that
                drive split/merge/demote/re-sync from live signals
  simharness    deterministic day-in-the-life simulation (SimClock,
                SimCluster, DriftingWorkload) for tests and benchmarks

Submodules are imported lazily, so pulling in one never drags the whole
index stack along.
"""

import importlib

_SUBMODULES = ("checkpoint", "shard_router", "parallel", "rebalance",
               "compression", "sharding", "on_mesh", "elastic",
               "autopilot", "simharness")

_LAZY_NAMES = {
    "ShardedWarren": "shard_router",
    "RoutingTable": "shard_router",
    "CheckpointManager": "checkpoint",
    "ScatterGather": "parallel",
    "ScatterTimings": "parallel",
    "Rebalancer": "rebalance",
    "RebalanceStats": "rebalance",
    "Controller": "autopilot",
    "AutopilotConfig": "autopilot",
    "Decision": "autopilot",
    "GroupSignal": "autopilot",
    "SimClock": "simharness",
    "SimCluster": "simharness",
    "DriftingWorkload": "simharness",
}

__all__ = list(_SUBMODULES) + list(_LAZY_NAMES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY_NAMES:
        mod = importlib.import_module(f".{_LAZY_NAMES[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
