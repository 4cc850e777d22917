"""repro_torch — the annotative index's serving paths in PyTorch and CUDA.

Three paths, each tested against the JAX package ``repro``:

- ranked retrieval: the host index (transactions, annotation lists,
  float64 impacts) in plain Python and numpy, scored on the card by the
  dense scorer in torch and the block-max pruned sweep, a hand-written
  CUDA kernel (``csrc/bm25_blockmax.cu``);
- structured retrieval: the GCL operators and query language, with the
  containment joins on the card (``csrc/interval_join.cu``);
- LM decode for RAG: the GQA transformer (``models/``, ``configs/``) and
  the continuous-batching ``serve.LMServer``, whose decode step runs
  split-KV flash-decoding attention (``csrc/gqa_decode.cu``).

Entry points take an explicit ``device`` and run on CUDA unless the caller
asks for the CPU.
"""
