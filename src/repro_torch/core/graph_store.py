"""Graphs as annotations (paper §2.5 and Conclusion).

Two encodings, both from the paper:

  direct:    ⟨G, p, v⟩            directed edge from content at address p to
                                   content at address v (value = address)
  edge-list: ⟨G, p, E⟩ + ⟨E, p'⟩   value = feature holding the out-edges
                                   (avoids dangling references on delete)

Subject-predicate-object triples: ⟨predicate, subject_addr, object_addr⟩.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from .json_store import ROOT_FEATURE, add_json, value_of
from .warren import Warren


class GraphStore:
    def __init__(self, warren: Warren):
        self.w = warren
        self._anchors: Dict[Tuple[str, int], int] = {}

    # -- nodes ----------------------------------------------------------- #
    def add_node(self, obj: Any, graph: str = "@node") -> Tuple[int, int]:
        lo, hi = add_json(self.w, obj)
        self.w.annotate(graph, lo, hi)
        return lo, hi

    # -- direct encoding --------------------------------------------------- #
    def add_edge(self, graph: str, src: int, dst: int,
                 anchor: Optional[int] = None) -> None:
        """⟨G, anchor, dst⟩ (paper §2.5): edge from the object containing
        ``src`` to the content at ``dst``.  Minimal-interval semantics allow
        one annotation per (feature, interval), so successive edges from the
        same source anchor at successive addresses inside the source object
        (the paper anchors each friend-edge at that friend's array slot)."""
        if anchor is None:
            key = (graph, src)
            anchor = src + self._anchors.get(key, 0)
            self._anchors[key] = self._anchors.get(key, 0) + 1
        self.w.annotate(graph, anchor, anchor, float(dst), v_is_address=True)

    def neighbors(self, graph: str, lo: int, hi: int) -> List[int]:
        """Target addresses of edges whose source lies inside [lo, hi]."""
        hop = self.w.hopper(graph)
        out = []
        t = hop.tau(lo)
        while t[1] <= hi:
            out.append(int(t[2]))
            t = hop.tau(t[0] + 1)
        return out

    # -- edge-list encoding (paper Conclusion) --------------------------------- #
    # ⟨G, p, E⟩ where the value E is a *feature* holding the out-edges as
    # ⟨E, p'⟩ annotations: no dangling references on delete — erased targets
    # simply vanish from E's annotation list.
    def add_out_edges(self, graph: str, src_extent: Tuple[int, int],
                      dst_addrs: List[int]) -> None:
        """Per-source edge-list feature E = "@edges:<graph>:<src_lo>"; the
        ⟨G:out, src, E⟩ annotation stores src_lo (< 2^53, exact in the value
        channel) and the out-edges are ⟨E, dst⟩ singletons, so deleting a
        target erases its edge entries with it — no dangling references.
        Use on *committed* extents (the annotate-later model): the feature
        name bakes in the permanent source address."""
        lo = src_extent[0]
        if lo < 0:
            raise ValueError("edge-list encoding requires committed extents")
        self.w.annotate(graph + ":out", lo, lo, float(lo))
        edge_feature = f"@edges:{graph}:{lo}"
        for dst in sorted(set(dst_addrs)):
            self.w.annotate(edge_feature, dst, dst)

    def out_edges(self, graph: str, src_extent: Tuple[int, int]) -> List[int]:
        lo = src_extent[0]
        hop = self.w.hopper(graph + ":out")
        t = hop.tau(lo)
        if t[0] != lo:
            return []
        edge_list = self.w.annotations(f"@edges:{graph}:{int(t[2])}")
        return [int(p) for p, _, _ in edge_list]

    # -- triples -------------------------------------------------------------- #
    def add_triple(self, subject_addr: int, predicate: str, object_addr: int) -> None:
        self.add_edge(f"@rel:{predicate}", subject_addr, object_addr)

    def objects_of(self, subject_extent: Tuple[int, int], predicate: str) -> List[int]:
        return self.neighbors(f"@rel:{predicate}", *subject_extent)

    # -- resolution -------------------------------------------------------------- #
    def containing_object(self, addr: int) -> Optional[Tuple[int, int]]:
        """The ':' extent containing an address (object identity)."""
        root = self.w.hopper(ROOT_FEATURE)
        t = root.rho(addr)          # first object ending >= addr
        if t[0] <= addr <= t[1]:
            return (t[0], t[1])
        return None

    def bfs(self, graph: str, start: Tuple[int, int], max_nodes: int = 1000
            ) -> Iterator[Tuple[int, int]]:
        seen = {start}
        frontier = [start]
        while frontier and len(seen) <= max_nodes:
            nxt: List[Tuple[int, int]] = []
            for node in frontier:
                yield node
                for addr in self.neighbors(graph, *node):
                    obj = self.containing_object(addr)
                    if obj is not None and obj not in seen:
                        seen.add(obj)
                        nxt.append(obj)
            frontier = nxt
