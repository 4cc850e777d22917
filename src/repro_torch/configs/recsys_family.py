"""The four recsys architectures of the JAX package, their batch sizes,
smoke configs, serving entry point, training batches and losses
(``src/repro/configs/recsys_family.py``).

  train_batch     batch 65,536      (training)
  serve_p99       batch 512         (online inference)
  serve_bulk      batch 262,144     (offline scoring)
  retrieval_cand  batch 1 × 1,000,000 candidates (retrieval scoring)

:func:`serve` computes what the reference's ``ArchSpec.serve_fn`` of each
architecture computes, :func:`loss_fn` what its ``loss_fn`` computes, and
:func:`train_batch` makes a ``train_batch`` (65,536) batch of the synth
generators at a configuration's sizes.  The ``ArchSpec`` registry and the
dry-run cells (built on ``jax.eval_shape``) are not ported;
:func:`get_config` looks a configuration up by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.data import synth
from repro_torch.models import recsys as R

BATCHES = {"train_batch": 65_536, "serve_p99": 512, "serve_bulk": 262_144}
N_CAND = 1_000_000
HIST_LEN = 8


# --------------------------------------------------------------------- #
def dlrm_smoke_batch(cfg, kind, seed=0):
    return synth.dlrm_batch(seed, 8, cfg.n_dense, cfg.n_sparse,
                            cfg.vocab_per_table)


def xdeepfm_smoke_batch(cfg, kind, seed=0):
    return synth.xdeepfm_batch(seed, 8, cfg.n_sparse, cfg.vocab_per_table)


def twotower_smoke_batch(cfg, kind, seed=0):
    b = synth.twotower_batch(seed, 8, cfg.n_users, cfg.n_items, HIST_LEN)
    if kind == "serve":
        b["cand_ids"] = np.arange(64, dtype=np.int32) % cfg.n_items
    return b


def sasrec_smoke_batch(cfg, kind, seed=0):
    b = synth.sasrec_batch(seed, 8, cfg.seq_len, cfg.n_items)
    if kind == "serve":
        b["cand_ids"] = (np.arange(64, dtype=np.int32) % cfg.n_items)
    return b


# --------------------------------------------------------------------- #
DLRM_RM2 = R.DLRMConfig()
DLRM_SMOKE = dataclasses.replace(DLRM_RM2, name="dlrm-smoke",
                                 vocab_per_table=1000, n_sparse=6,
                                 bot_mlp=(13, 32, 16), top_mlp=(32, 16, 1),
                                 embed_dim=16)
XDEEPFM = R.XDeepFMConfig()
XDEEPFM_SMOKE = dataclasses.replace(XDEEPFM, name="xdeepfm-smoke",
                                    vocab_per_table=500, n_sparse=6,
                                    cin_layers=(8, 8), mlp=(16,), embed_dim=4)
TWOTOWER = R.TwoTowerConfig()
TWOTOWER_SMOKE = dataclasses.replace(TWOTOWER, name="two-tower-smoke",
                                     n_users=1000, n_items=500,
                                     tower_mlp=(32, 16), embed_dim=16)
SASREC = R.SASRecConfig()
SASREC_SMOKE = dataclasses.replace(SASREC, name="sasrec-smoke", n_items=200,
                                   embed_dim=16, seq_len=20)

# name → (config, smoke config, smoke batch)
ARCHS = {
    "dlrm-rm2": (DLRM_RM2, DLRM_SMOKE, dlrm_smoke_batch),
    "xdeepfm": (XDEEPFM, XDEEPFM_SMOKE, xdeepfm_smoke_batch),
    "two-tower-retrieval": (TWOTOWER, TWOTOWER_SMOKE, twotower_smoke_batch),
    "sasrec": (SASREC, SASREC_SMOKE, sasrec_smoke_batch),
}


def get_config(name: str, smoke: bool = False):
    """The configuration ``name`` (one of :data:`ARCHS`), or its smoke
    config with ``smoke=True``."""
    if name not in ARCHS:
        raise KeyError(f"unknown recsys config {name!r}; known: "
                       f"{sorted(ARCHS)}")
    return ARCHS[name][1 if smoke else 0]


def smoke_batch(name: str, kind: str = "serve", seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """The reference's smoke batch of ``name`` (numpy, 8 examples; with
    64 shared candidates for two-tower and SASRec when ``kind`` is
    ``"serve"``)."""
    _, smoke, fn = ARCHS[name]
    return fn(smoke, kind, seed)


def serve(name: str, model: R._Recsys, batch: Mapping) -> torch.Tensor:
    """What the reference's ``serve_fn`` of ``name`` computes, on the
    model's device (numpy arrays in ``batch`` are copied there):

    - ``dlrm-rm2``: ``dlrm_forward(dense, sparse)`` → logits [B];
    - ``xdeepfm``: ``xdeepfm_forward(sparse)`` → logits [B];
    - ``two-tower-retrieval``: with ``cand_ids``, the candidates' scores
      [B, n_cand]; else the user embeddings [B, D];
    - ``sasrec``: with ``cand_ids``, the candidates' scores; else the
      hidden states [B, S, D].
    """
    cfg_type = type(get_config(name))
    if not isinstance(model.cfg, cfg_type):
        raise TypeError(f"{name} serves a {cfg_type.__name__} model, got "
                        f"{type(model.cfg).__name__}")
    dev = model.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if name == "dlrm-rm2":
        return R.dlrm_forward(model, b["dense"], b["sparse"])
    if name == "xdeepfm":
        return R.xdeepfm_forward(model, b["sparse"])
    if name == "two-tower-retrieval":
        if "cand_ids" in b:
            return R.twotower_score_candidates(model, b)
        return R.twotower_user_embed(model, b["user_ids"], b["hist_ids"],
                                     b["hist_w"])
    if "cand_ids" in b:
        return R.sasrec_score_candidates(model, b)
    return R.sasrec_encode(model, b["item_seq"])


def train_batch(name: str, cfg, batch: int = BATCHES["train_batch"],
                seed: int = 0) -> Dict[str, np.ndarray]:
    """A training batch of ``batch`` examples (numpy) for ``name`` at
    ``cfg``'s sizes, from the synth generator the reference's cells use:
    DLRM dense, sparse and labels; xDeepFM sparse and labels; two-tower
    users, history bags of HIST_LEN, items and logQ; SASRec sequences
    with their positive and negative items."""
    if name == "dlrm-rm2":
        return synth.dlrm_batch(seed, batch, cfg.n_dense, cfg.n_sparse,
                                cfg.vocab_per_table)
    if name == "xdeepfm":
        return synth.xdeepfm_batch(seed, batch, cfg.n_sparse,
                                   cfg.vocab_per_table)
    if name == "two-tower-retrieval":
        return synth.twotower_batch(seed, batch, cfg.n_users, cfg.n_items,
                                    HIST_LEN)
    if name == "sasrec":
        return synth.sasrec_batch(seed, batch, cfg.seq_len, cfg.n_items)
    raise KeyError(f"unknown recsys config {name!r}")


LOSSES = {"dlrm-rm2": R.dlrm_loss, "xdeepfm": R.xdeepfm_loss,
          "two-tower-retrieval": R.twotower_loss, "sasrec": R.sasrec_loss}


def loss_fn(name: str, model: R._Recsys, batch: Mapping) -> torch.Tensor:
    """The training loss of ``name`` on ``batch`` (numpy arrays are copied
    to the model's device): DLRM's and xDeepFM's BCE, two-tower's in-batch
    softmax with logQ, SASRec's next-item BCE."""
    if name not in LOSSES:
        raise KeyError(f"unknown recsys config {name!r}")
    dev = model.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return LOSSES[name](model, b)
