"""Training launcher: ``--arch <name>`` at its smoke config, an LM or a
recsys model looked up with ``get_config`` (``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \
      --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --index-backed --steps 40 --crash-at 17 --ckpt-dir /tmp/ck

Weights are drawn from seed 0; batches are the reference's smoke
batches at consecutive seeds.  ``--index-backed`` (LM configs) runs the
pipeline of ``examples/train_lm.py``: ``--docs`` seeded documents ingested
into a ``Warren``, duplicates and 64-token windows annotated, batches of 4
hydrated by ``IndexedCorpusLoader``, and ``run_with_restarts`` with the
crash ``--crash-at`` injected once.  Runs on the card unless ``--device
cpu`` is given.
"""

import argparse
import os
import tempfile
import time

SEED = 0
INDEX_BATCH = 4
INDEX_SEQ = 64


def _model_and_loss(arch: str, dev, seed: int):
    import torch

    from repro_torch.configs import lm_family, recsys_family
    from repro_torch.models import recsys, transformer
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if arch in lm_family.CONFIGS:
        cfg = lm_family.get_config(arch, smoke=True)
        return (cfg, transformer.init_params(cfg, gen, dev),
                lm_family.loss_fn,
                lambda s: lm_family.smoke_batch(cfg, "train", seed=s))
    cfg = recsys_family.get_config(arch, smoke=True)
    return (cfg, recsys.init_params(cfg, gen, dev),
            lambda m, b: recsys_family.loss_fn(arch, m, b),
            lambda s: recsys_family.smoke_batch(arch, "train", seed=s))


def _batches(make):
    seed = 0
    while True:
        yield make(seed)
        seed += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--index-backed", action="store_true",
                    help="LM batches from the annotative-index pipeline")
    ap.add_argument("--docs", type=int, default=200)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a failure once (--index-backed)")
    args = ap.parse_args(argv)

    from repro_torch.configs import lm_family
    from repro_torch.device import resolve_device
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    dev = resolve_device(args.device)
    if args.index_backed and args.arch not in lm_family.CONFIGS:
        raise SystemExit("--index-backed needs an LM config")

    cfg, model, loss_fn, make_batch = _model_and_loss(args.arch, dev, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{args.arch} (smoke config {cfg.name}) on {dev}: "
          f"{n_params / 1e6:.2f}M params")
    tc = TrainerConfig(total_steps=args.steps,
                       ckpt_every=max(args.steps // 2, 1),
                       ckpt_dir=args.ckpt_dir,
                       log_every=max(args.steps // 5, 1),
                       opt=AdamWConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=args.steps))
    t0 = time.time()
    if args.index_backed:
        trainer = _train_index_backed(args, cfg, loss_fn, tc, dev)
    else:
        trainer = Trainer(loss_fn, model, tc, _batches(make_batch))
        trainer.train()
    dt = time.time() - t0
    for m in trainer.metrics_log:
        print(f"  step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"|g| {m['grad_norm']:.3f}")
    print(f"{trainer.step} steps in {dt:.1f}s "
          f"({trainer.step / dt:.2f} steps/s)")
    return trainer


def _train_index_backed(args, cfg, loss_fn, tc, dev):
    import dataclasses

    import torch

    from repro_torch.core import DynamicIndex, Warren
    from repro_torch.data.pipeline import (IndexedCorpusLoader, ingest,
                                           mark_duplicates, segment)
    from repro_torch.data.synth import doc_generator
    from repro_torch.models import transformer
    from repro_torch.train.trainer import Trainer, run_with_restarts

    warren = Warren(DynamicIndex())
    t0 = time.time()
    n = ingest(warren, doc_generator(SEED, args.docs, mean_len=120))
    dups = mark_duplicates(warren)
    segs = segment(warren, window=INDEX_SEQ, stride=INDEX_SEQ // 2)
    print(f"pipeline: {n} docs, {dups} dups, {segs} segments "
          f"({time.time() - t0:.1f}s)")
    ckpt_dir = tc.ckpt_dir
    if ckpt_dir is None and args.crash_at is not None:
        ckpt_dir = tempfile.mkdtemp(prefix="lm_ckpt_")
    tc = dataclasses.replace(tc, ckpt_dir=ckpt_dir,
                             ckpt_every=max(args.steps // 4, 1))

    def make_trainer():
        loader = IndexedCorpusLoader(warren, vocab=cfg.vocab,
                                     batch=INDEX_BATCH, seq_len=INDEX_SEQ)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        return Trainer(loss_fn, transformer.init_params(cfg, gen, dev), tc,
                       loader, data_state_fn=loader.state,
                       data_restore_fn=loader.restore)

    trainer = run_with_restarts(make_trainer, fail_at=args.crash_at)
    if ckpt_dir is not None:
        print(f"checkpoints in {ckpt_dir}: "
              f"{sorted(os.listdir(ckpt_dir))}")
    return trainer


if __name__ == "__main__":
    main()
