"""Elastic capacity: repartition state when the mesh or shard count changes
(``src/repro/dist/elastic.py``).

Two distinct paths live here, for two distinct failure/scale modes:

* **Offline repartition** (mesh shrink): when a pod (or a slice of one)
  drops out, the scheduler hands back fewer devices.  Recovery is: pick a
  new mesh shape (``shrink_mesh``), rebuild the mesh
  (``launch.mesh.make_mesh_from_sizes``), restore the latest-good
  checkpoint, and move every leaf onto its new placements (``reshard``).
  Index shards are repartitioned the same way (``repartition_shards`` /
  ``repartition_replica_groups``): document lists re-route by a stable
  hash and the warren is *rebuilt* — correct, but the collection is
  offline while it happens.
* **Live rebalance** (capacity change under load): ``split_shard_group``
  and ``merge_shard_groups`` reshape a *running* ShardedWarren through
  :class:`repro_torch.dist.rebalance.Rebalancer`.

Repartition invariants: the output always has exactly ``k_new`` groups —
a shard left unpopulated by the hash is returned as an *empty, addressable*
group, never dropped, because group ids are positional.  Routing is
deterministic (keyed blake2b over the item's repr), so repeating a
repartition with the same inputs lands every item on the same shard.

The host logic is the reference's, bit for bit.  ``reshard`` is the
port's: DTensor's ``redistribute`` on the same mesh; onto another mesh
(the elastic restart) every leaf gathered whole (``full_tensor``) and
distributed anew.  The reference's ``autopilot`` (a controller over
``dist/autopilot.py``) is not here.

A note on ``_impl`` names: as in ``dist/shard_router.py``, each function
the reference's lock analysis may reach by name is defined under an
``_impl`` name and bound to its public name by assignment, so a call from
either package resolves to one definition.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional


def _reshard_impl(state: Mapping, placements, mesh=None) -> Dict:
    """Every DTensor leaf of ``state`` (a dict, nested dicts allowed) on
    ``placements`` (a matching dict of placement tuples, or one tuple for
    every leaf).  On its own mesh (``mesh`` None or the leaf's) this is
    ``redistribute``; onto another ``mesh`` each leaf is gathered whole
    (``full_tensor``) and distributed from it.  Plain tensors are
    distributed onto ``mesh``.  Returns a new dict of the same keys."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, places):
        places = tuple(places)
        if isinstance(x, DTensor) and (mesh is None
                                       or x.device_mesh == mesh):
            return x.redistribute(x.device_mesh, places)
        if mesh is None:
            raise ValueError("a plain tensor needs the mesh to go onto")
        whole = x.full_tensor() if isinstance(x, DTensor) else x
        return distribute_tensor(whole, mesh, places)

    def walk(node, places):
        if isinstance(node, Mapping):
            return {k: walk(v, places[k] if isinstance(places, Mapping)
                            else places) for k, v in node.items()}
        return one(node, places)

    return walk(state, placements)


reshard = _reshard_impl   # see the note on ``_impl`` names


def _shrink_mesh_impl(sizes: Dict[str, int], lost_devices: int,
                      preserve: str = "model") -> Dict[str, int]:
    """New mesh axis sizes after losing ``lost_devices`` devices.

    Policy: tensor-parallel width (``preserve``) is never touched — param
    layouts and compiled kernels assume it.  The largest remaining axis is
    halved (keeping power-of-two shapes restartable from FSDP checkpoints)
    until the mesh fits in the surviving device count.
    """
    new = dict(sizes)
    total = 1
    for v in new.values():
        total *= v
    budget = total - lost_devices
    if budget < 1:
        raise ValueError(f"lost {lost_devices} of {total} devices")

    def prod():
        p = 1
        for v in new.values():
            p *= v
        return p

    while prod() > budget:
        candidates = [a for a, v in new.items() if a != preserve and v > 1]
        if not candidates:
            raise ValueError(
                f"cannot shrink {sizes} into {budget} devices while "
                f"preserving axis {preserve!r}")
        axis = max(candidates, key=lambda a: new[a])
        new[axis] //= 2
    return new


shrink_mesh = _shrink_mesh_impl   # see the note on ``_impl`` names


def _repartition_shards_impl(shard_docs: List[List], k_new: int,
                             route=None) -> List[List]:
    """Redistribute per-shard item lists onto exactly ``k_new`` shards.

    ``route(item, k) -> shard`` defaults to stable hashing of the item's
    repr; items already on the right shard stay put (minimal movement when
    k_new == k_old).  Shards the hash leaves unpopulated come back as empty
    lists — they stay addressable, because shard identity is positional.
    A route landing outside [0, k_new) is an error, not a silent reshuffle.
    """
    if k_new < 1:
        raise ValueError(f"k_new must be >= 1, got {k_new}")
    if route is None:
        def route(item, k):
            import hashlib
            h = hashlib.blake2b(repr(item).encode(), digest_size=8)
            return int.from_bytes(h.digest(), "big") % k
    out: List[List] = [[] for _ in range(k_new)]
    for items in shard_docs:
        for item in items:
            shard = route(item, k_new)
            if not 0 <= shard < k_new:
                raise ValueError(
                    f"route({item!r}, {k_new}) returned {shard}")
            out[shard].append(item)
    return out


repartition_shards = _repartition_shards_impl   # see the note on _impl


def _repartition_replica_groups_impl(group_docs: List[List], k_new: int,
                                     replicas: int = 1,
                                     route=None) -> List[List[List]]:
    """Repartition *whole replica groups* onto ``k_new`` logical shards.

    ``group_docs`` holds one item list per current shard group (replicas of
    a group are lockstep-identical, so one list describes the whole group).
    Items are re-routed with the same stable hash as ``repartition_shards``,
    then every new group's list is fanned out to ``replicas`` copies —
    replicas always move together, a group is never split across shards.

    Returns exactly ``k_new`` groups, each a list of ``replicas`` identical
    item lists (independent list objects).  A group the hash leaves empty
    is still returned with its ``replicas`` empty lists.
    """
    if replicas < 1:
        raise ValueError("replicas must be >= 1")
    flat = repartition_shards(group_docs, k_new, route)
    assert len(flat) == k_new       # empty groups stay addressable
    return [[list(items) for _ in range(replicas)] for items in flat]


repartition_replica_groups = _repartition_replica_groups_impl   # see _impl


# ------------------------------------------------------------------ #
# live rebalancing (streaming, no writer pause) — see dist.rebalance
# ------------------------------------------------------------------ #
def _split_shard_group_impl(warren, source: int, pivot: Optional[int] = None,
                            pool=None, rebalancer=None) -> int:
    """Split a live ShardedWarren replica group in two without pausing
    writers; returns the new group id.  Thin wrapper over
    :class:`repro_torch.dist.rebalance.Rebalancer`: pass ``rebalancer`` (one
    over ``warren``) to read the stall stats from its ``last_stats``, or use
    the Rebalancer directly to batch several operations."""
    return _rebalancer(warren, pool, rebalancer).split_group(source,
                                                             pivot=pivot)


split_shard_group = _split_shard_group_impl   # see the note on _impl


def _rebalancer(warren, pool, rebalancer):
    """The caller's Rebalancer over ``warren``, or a new one on ``pool``."""
    from repro_torch.dist.rebalance import Rebalancer

    if rebalancer is None:
        return Rebalancer(warren, pool=pool)
    if rebalancer.warren is not warren or pool is not None:
        raise ValueError("pass either a Rebalancer over this warren or a "
                         "pool, not both")
    return rebalancer


def _merge_shard_groups_impl(warren, dest: int, source: int,
                             pool=None, rebalancer=None) -> None:
    """Fold one live replica group into another without pausing writers
    (demoted groups merge by shipping run manifests); the absorbed group
    is retired in place.  ``rebalancer`` as for :func:`split_shard_group`;
    see :class:`repro_torch.dist.rebalance.Rebalancer`."""
    _rebalancer(warren, pool, rebalancer).merge_groups(dest, source)


merge_shard_groups = _merge_shard_groups_impl   # see the note on _impl
