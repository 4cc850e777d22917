"""repro_torch.train — the training loop (``src/repro/train``).

  optimizer  AdamW with clipping and the warmup-cosine schedule, updated in
             place; ``make_train_step`` (loss, backward, optional gradient
             compression, update)
  trainer    Trainer: prefetch with skip-and-backfill, async checkpoints
             that carry the data cursor, ``run_with_restarts``
"""
