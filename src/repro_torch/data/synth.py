"""Seeded synthetic data: Zipfian TREC-like documents, LM token batches,
the schema-heterogeneous JSON collections of the paper's Fig. 5, the
graphs of the GNN cells (a random graph, a batch of small molecules and a
fanout neighbour sampler) and the recsys batches.

The same seed yields the same documents, objects, graphs, samples and
batches as the reference package's ``doc_generator``, ``token_batches``,
``json_collection``, ``random_graph``, ``molecule_batch``,
``NeighborSampler`` and ``*_batch``, bit for bit, so both index, train on
and score the same data.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

_WORDS = """time year people way day man thing woman life child world school
state family student group country problem hand part place case week company
system program question work government number night point home water room
mother area money story fact month lot right study book eye job word business
issue side kind head house service friend father power hour game line end
member law car city community name president team minute idea body
information back parent face others level office door health person art war
history party result change morning reason research girl guy moment air
teacher force education vibration transmission conductor aeolian wind
frequency damping resonance amplitude""".split()


def doc_generator(seed: int, n_docs: int, mean_len: int = 80) -> Iterator[Tuple[str, str]]:
    """Yields (docid, text) with Zipfian vocabulary (TREC-like)."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(_WORDS) + 1) ** 1.1
    probs /= probs.sum()
    for i in range(n_docs):
        n = max(8, int(rng.normal(mean_len, mean_len / 3)))
        words = rng.choice(_WORDS, size=n, p=probs)
        yield f"doc{seed}_{i}", " ".join(words)


def token_batches(seed: int, vocab: int, batch: int, seq_len: int,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic LM batches; resumable from any step (ckpt restart)."""
    step = start_step
    while True:
        rng = np.random.default_rng(hash((seed, step)) % 2**32)
        toks = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32),
               "step": step}
        step += 1


def json_collection(seed: int = 0, scale: float = 1.0) -> Dict[str, list]:
    """Schema-heterogeneous JSON subcollections matching Fig. 5's shapes."""
    rng = np.random.default_rng(seed)
    cities = ["new york", "brooklyn", "queens", "albany", "buffalo"]
    cuisines = ["pizza", "thai", "diner", "bakery", "sushi"]
    results = ["pass", "fail", "violation", "warning"]
    cats = ["software", "web", "nanotech", "biotech", "games"]
    n = lambda k: max(2, int(k * scale))

    def date_h(i):  # human-readable
        return f"{'Jan Feb Mar Apr May Jun Jul Aug Sep Oct Nov Dec'.split()[i % 12]} {i % 28 + 1} {2005 + i % 10}"

    books = [{"title": f"technical book {i} on {rng.choice(cats)}",
              "authors": [f"author {rng.integers(50)}" for _ in range(rng.integers(1, 4))],
              "pageCount": int(rng.integers(80, 900)),
              "created": f"{2005 + i % 10}-{i % 12 + 1:02d}-{i % 28 + 1:02d}",
              "status": "PUBLISH"} for i in range(n(40))]
    zips = [{"city": str(rng.choice(cities)), "zip": f"{10000 + i}",
             "pop": int(rng.integers(1000, 90000)), "state": "NY"}
            for i in range(n(120))]
    restaurants = [{"name": f"restaurant {i}", "cuisine": str(rng.choice(cuisines)),
                    "rating": float(np.round(rng.random() * 5, 1)),
                    "city": str(rng.choice(cities))} for i in range(n(80))]
    inspections = [{"id": f"insp-{i}", "result": str(rng.choice(results)),
                    "sector": str(rng.choice(cats)),
                    "date": date_h(i)} for i in range(n(300))]
    companies = [{"name": f"company {i}", "category_code": str(rng.choice(cats)),
                  "founded_year": int(2000 + i % 20),
                  "created_at": {"$date": int(1.1e12 + rng.integers(0, 3e11))},
                  "description": f"a {rng.choice(cats)} company doing {rng.choice(cats)}"}
                 for i in range(n(150))]
    trades = [{"ticker": str(rng.choice(["AAA", "BBB", "CCC"])),
               "price": float(np.round(10 + rng.random() * 90, 2)),
               "qty": int(rng.integers(1, 1000))} for i in range(n(500))]
    return {"books": books, "zips": zips, "restaurant": restaurants,
            "city_inspections": inspections, "companies": companies,
            "trades": trades}


# ------------------------------------------------------------------ #
# graphs
# ------------------------------------------------------------------ #
def random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int = 0,
                 n_classes: int = 0) -> Dict[str, np.ndarray]:
    """A spatial graph of ``n_nodes`` nodes and ``n_edges`` uniform random
    edges: positions N(0, 3²), species in [0, 16), sparse binary features
    and labels where asked."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    receivers = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    out = {
        "positions": rng.standard_normal((n_nodes, 3)).astype(np.float32) * 3,
        "species": rng.integers(0, 16, size=n_nodes, dtype=np.int32),
        "senders": senders, "receivers": receivers,
    }
    if d_feat:
        out["node_feats"] = (rng.standard_normal((n_nodes, d_feat)) < -1
                             ).astype(np.float32)  # sparse binary features
    if n_classes:
        out["labels"] = rng.integers(0, n_classes, size=n_nodes, dtype=np.int32)
        out["label_mask"] = np.ones(n_nodes, np.float32)
    return out


def molecule_batch(seed: int, batch: int = 128, n_nodes: int = 30,
                   n_edges: int = 64) -> Dict[str, np.ndarray]:
    """Batched small molecules with energies/forces (padded batching)."""
    rng = np.random.default_rng(seed)
    N, E = batch * n_nodes, batch * n_edges
    pos = rng.standard_normal((N, 3)).astype(np.float32)
    senders = np.concatenate([
        rng.integers(0, n_nodes, n_edges) + g * n_nodes for g in range(batch)
    ]).astype(np.int32)
    receivers = np.concatenate([
        rng.integers(0, n_nodes, n_edges) + g * n_nodes for g in range(batch)
    ]).astype(np.int32)
    return {
        "positions": pos,
        "species": rng.integers(0, 16, size=N, dtype=np.int32),
        "senders": senders, "receivers": receivers,
        "graph_ids": np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        "n_graphs": batch,
        "energies": rng.standard_normal(batch).astype(np.float32),
        "forces": rng.standard_normal((N, 3)).astype(np.float32) * 0.1,
    }


class NeighborSampler:
    """Real fanout sampler over a CSR adjacency (minibatch_lg shape).

    GraphSAGE-style layered sampling: seed nodes, then `fanout[i]` neighbors
    per node per hop, with padding by self-loops when degree is short."""

    def __init__(self, n_nodes: int, senders: np.ndarray, receivers: np.ndarray):
        order = np.argsort(receivers, kind="stable")
        self.dst_sorted = receivers[order]
        self.src_sorted = senders[order]
        self.indptr = np.searchsorted(self.dst_sorted, np.arange(n_nodes + 1))
        self.n_nodes = n_nodes

    def sample(self, seed_nodes: np.ndarray, fanouts: List[int],
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """The sampled subgraph: its ``nodes`` (parent ids, sorted), its
        edges in local ids, and the seeds' local ids."""
        layers = [seed_nodes.astype(np.int32)]
        all_src, all_dst = [], []
        frontier = seed_nodes
        for f in fanouts:
            lo = self.indptr[frontier]
            deg = self.indptr[frontier + 1] - lo
            # sample f neighbors per frontier node (with replacement; self-
            # loop when isolated)
            r = rng.integers(0, np.maximum(deg, 1)[:, None],
                             size=(len(frontier), f))
            src = np.where(deg[:, None] > 0,
                           self.src_sorted[np.minimum(lo[:, None] + r,
                                                      len(self.src_sorted) - 1)],
                           frontier[:, None])
            dst = np.broadcast_to(frontier[:, None], src.shape)
            all_src.append(src.reshape(-1))
            all_dst.append(dst.reshape(-1))
            frontier = np.unique(src)
            layers.append(frontier.astype(np.int32))
        nodes = np.unique(np.concatenate(layers))
        lut = np.zeros(self.n_nodes, np.int32)
        lut[nodes] = np.arange(len(nodes), dtype=np.int32)
        senders = lut[np.concatenate(all_src)]
        receivers = lut[np.concatenate(all_dst)]
        return {"nodes": nodes.astype(np.int32), "senders": senders,
                "receivers": receivers,
                "seed_local": lut[seed_nodes.astype(np.int64)]}


# ------------------------------------------------------------------ #
# recsys
# ------------------------------------------------------------------ #
def dlrm_batch(seed: int, batch: int, n_dense=13, n_sparse=26,
               vocab=1_000_000) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.standard_normal((batch, n_dense)).astype(np.float32),
        "sparse": (rng.zipf(1.2, size=(batch, n_sparse)) % vocab).astype(np.int32),
        "labels": (rng.random(batch) < 0.25).astype(np.float32),
    }


def xdeepfm_batch(seed: int, batch: int, n_sparse=39,
                  vocab=100_000) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "sparse": (rng.zipf(1.2, size=(batch, n_sparse)) % vocab).astype(np.int32),
        "labels": (rng.random(batch) < 0.2).astype(np.float32),
    }


def twotower_batch(seed: int, batch: int, n_users=2_000_000, n_items=1_000_000,
                   hist_len=8) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    item_ids = (rng.zipf(1.2, size=batch) % n_items).astype(np.int32)
    freq = np.maximum(1.0 / (1.0 + item_ids), 1e-9)
    return {
        "user_ids": rng.integers(0, n_users, batch).astype(np.int32),
        "hist_ids": (rng.zipf(1.3, size=(batch, hist_len)) % n_items).astype(np.int32),
        "hist_w": (rng.random((batch, hist_len)) < 0.9).astype(np.float32),
        "item_ids": item_ids,
        "logq": np.log(freq).astype(np.float32),
    }


def sasrec_batch(seed: int, batch: int, seq_len=50,
                 n_items=1_000_000) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    seq = (rng.zipf(1.3, size=(batch, seq_len)) % n_items).astype(np.int32)
    # zero-pad prefixes of random length
    lens = rng.integers(3, seq_len + 1, batch)
    mask = np.arange(seq_len)[None, :] >= (seq_len - lens[:, None])
    seq = np.where(mask, np.maximum(seq, 1), 0).astype(np.int32)
    pos = np.roll(seq, -1, axis=1)
    pos[:, -1] = np.maximum(rng.integers(1, n_items, batch), 1)
    pos = np.where(seq != 0, pos, 0).astype(np.int32)
    neg = np.where(seq != 0, (rng.zipf(1.3, size=(batch, seq_len)) % n_items)
                   .astype(np.int32), 0)
    return {"item_seq": seq, "pos_items": pos,
            "neg_items": np.maximum(neg, 1) * (seq != 0)}
