"""The five LM-family transformers of the JAX package, their shapes, and
smoke configs (``src/repro/configs/lm_family.py``).

Shapes:
  train_4k     seq 4,096  × global_batch 256   (train_step)
  prefill_32k  seq 32,768 × global_batch 32    (serve: prefill)
  decode_32k   one token, KV cache 32,768, batch 128   (serve: decode)
  long_500k    one token, KV cache 524,288, batch 1    (serve: decode)

The JAX package's ``ArchSpec`` registry (built on ``jax.eval_shape`` for
its dry run) is not ported; :func:`get_config` looks a configuration up by
name.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.transformer import MoEConfig, TransformerConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="serve_prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="serve_decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="serve_decode"),
}


def _smoke(cfg: TransformerConfig, **over) -> TransformerConfig:
    base = dict(
        name=cfg.name + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 // cfg.group_size if cfg.group_size <= 4 else 1),
        head_dim=16, d_ff=128, vocab=512, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta, max_seq_len=256,
        dtype="float32",
    )
    if cfg.moe is not None:
        base["moe"] = MoEConfig(
            n_experts=8, top_k=min(cfg.moe.top_k, 4),
            d_expert_ff=32,
            n_shared=cfg.moe.n_shared,
            d_shared_ff=64 if cfg.moe.n_shared else 0)
    base.update(over)
    return TransformerConfig(**base)


QWEN2_5_14B = TransformerConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152_064, head_dim=128, qkv_bias=True, rope_theta=1e6)

YI_9B = TransformerConfig(
    name="yi-9b", n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64_000, head_dim=128, rope_theta=1e4)

INTERNLM2_1_8B = TransformerConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92_544, head_dim=128, rope_theta=1e6)

QWEN3_MOE_235B = TransformerConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, d_ff=1536, vocab=151_936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert_ff=1536))

QWEN2_MOE_A2_7B = TransformerConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=151_936, head_dim=128, qkv_bias=True,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert_ff=1408,
                  n_shared=4, d_shared_ff=5632))

CONFIGS: Dict[str, TransformerConfig] = {
    c.name: c for c in [QWEN2_5_14B, YI_9B, INTERNLM2_1_8B, QWEN3_MOE_235B,
                        QWEN2_MOE_A2_7B]}


def get_config(name: str, smoke: bool = False) -> TransformerConfig:
    """The configuration ``name`` (one of :data:`CONFIGS`), or its smoke
    config (2 layers, width 64, float32) with ``smoke=True``."""
    if name not in CONFIGS:
        raise KeyError(f"unknown LM config {name!r}; known: "
                       f"{sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return _smoke(cfg) if smoke else cfg
