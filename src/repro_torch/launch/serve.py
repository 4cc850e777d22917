"""Serving launcher: BM25 retrieval over a seeded corpus, or LM decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000
  PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --docs 1000 --shards 4 \
      --async-scatter
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch qwen2.5-14b --tokens 8 --device cpu

``--mode retrieval`` (the default) indexes ``--docs`` seeded documents and
serves BM25 queries, from a ``ShardedWarren`` of ``--shards`` groups served
natively when ``--shards`` > 1; ``--mode lm`` decodes four prompts through
``LMServer`` with the smoke config of ``--arch`` and random weights from
``--seed``.  Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import time


def serve_lm(args):
    import torch

    from repro_torch.configs.lm_family import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import LMServer
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = init_params(cfg, gen, dev)
    server = LMServer(model, max_slots=4, max_len=64, device=dev)
    prompts = [[1, 5, 9], [2, 7], [3, 3, 3, 3], [4]]
    t0 = time.time()
    outs = server.generate(prompts, max_new=args.tokens)
    dt = time.time() - t0
    total = sum(len(o) for o in outs)
    print(f"decoded {total} tokens for {len(prompts)} sequences on {dev} in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, continuous batching)")
    for p, o in zip(prompts, outs):
        print(f"  prompt {p} -> {o[:8]}")


def serve_retrieval(args):
    from repro_torch.core import DynamicIndex, Warren, ingest_documents
    from repro_torch.data.synth import doc_generator
    from repro_torch.serve import RetrievalServer
    if args.shards > 1:
        from repro_torch.dist.shard_router import ShardedWarren
        warren = ShardedWarren(n_shards=args.shards,
                               async_scatter=args.async_scatter)
    else:
        warren = Warren(DynamicIndex())
    t0 = time.time()
    ingest_documents(warren, doc_generator(args.seed, args.docs), batch=256)
    print(f"indexed {args.docs} docs in {time.time() - t0:.2f}s")
    server = None
    try:
        server = RetrievalServer(warren, k=10, device=args.device)
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
        if server is not None:
            server.close()
        if args.shards > 1:
            warren.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["retrieval", "lm"],
                    default="retrieval")
    ap.add_argument("--docs", type=int, default=1000,
                    help="retrieval mode: documents to index")
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help="lm mode: the config whose smoke config decodes")
    ap.add_argument("--tokens", type=int, default=8,
                    help="lm mode: new tokens per prompt")
    ap.add_argument("--shards", type=int, default=1,
                    help="retrieval mode: serve a ShardedWarren natively")
    ap.add_argument("--async-scatter", action="store_true",
                    help="with --shards: pool-based per-group fan-out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        serve_lm(args)
    else:
        serve_retrieval(args)


if __name__ == "__main__":
    main()
