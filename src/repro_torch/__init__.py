"""repro_torch — the annotative index's retrieval path in PyTorch and CUDA.

The host side (index, transactions, ranking annotations) is plain Python and
numpy; scoring runs on the card: the dense scorer as torch ops, the
block-max pruned sweep as a hand-written CUDA kernel
(``csrc/bm25_blockmax.cu``).  Entry points take an explicit ``device`` and
run on CUDA unless the caller asks for the CPU.
"""
