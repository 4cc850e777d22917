"""Serving launcher: index a seeded corpus, then serve BM25 queries.

  PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000
  PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000 --device cpu

Scores on the card unless ``--device cpu`` is given.
"""

import argparse
import time


def serve_retrieval(args):
    from repro_torch.core import DynamicIndex, Warren, ingest_documents
    from repro_torch.data.synth import doc_generator
    from repro_torch.serve import RetrievalServer
    warren = Warren(DynamicIndex())
    t0 = time.time()
    ingest_documents(warren, doc_generator(args.seed, args.docs), batch=256)
    print(f"indexed {args.docs} docs in {time.time() - t0:.2f}s")
    server = RetrievalServer(warren, k=10, device=args.device)
    try:
        queries = ["vibration conductor", "school student",
                   "stock money"] * 8
        t0 = time.time()
        handles = [server.batcher.submit(q) for q in queries]
        results = [h.get(timeout=60) for h in handles]
        dt = time.time() - t0
        print(f"served {len(queries)} queries on {server.device} in "
              f"{dt:.2f}s ({1e3 * dt / len(queries):.2f} ms/query, "
              f"micro-batched)")
        print(f"breakdown: {server.timing_summary()}")
        print(f"top-3 for {queries[0]!r}: {results[0][:3]}")
    finally:
        server.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to score on (default: cuda)")
    serve_retrieval(ap.parse_args(argv))


if __name__ == "__main__":
    main()
