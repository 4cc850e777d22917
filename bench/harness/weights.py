"""The benchmark's model shapes and random weights.

A configuration file (``bench/configs/<name>.json``) holds the published
keys; :func:`model_shape` reads the sizes the benchmark needs from them.
:func:`make_weights` draws one flat buffer of every weight in the served
dtype on the device from the seed, in one call, and hands out views of it
by leaf name: the program's model is built over those views, and the
reference regenerates the same buffer from the same seed, so it takes
nothing that the program has made.

The draw is conditioned so that a bfloat16 run stays close to float32
and a lower precision does not: inputs to each product N(0, 1/fan_in), the
products that feed the residual stream scaled by 1/sqrt(2 L), norms
1 + N(0, 0.1^2), the embedding N(0, 1), the router at twice the fan-in
scale (so the routed experts carry a real share), biases N(0, BIAS^2)
(a value bias adds one vector to every token's residual, so the routing
is uneven, as a trained model's is).
The mix's ``init`` sets attention's sharpness: ``key_gain`` scales every
key projection (scores of std ``key_gain``), and ``self_key_gain`` > 0
makes each KV head's key projection that gain times the query projection
of the first query head of its group, so that head attends to the token
it has just written to the cache.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Tuple

import torch

ALIGN = 256              # elements: every leaf starts 512-byte aligned
BIAS = 0.1               # std of the q, k and v biases
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MoEShape:
    n_experts: int
    top_k: int
    d_expert: int
    d_shared: int
    norm_topk: bool
    capacity_factor: float


@dataclasses.dataclass(frozen=True)
class ModelShape:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    max_positions: int
    eps: float
    qkv_bias: bool
    dtype: str
    moe: Optional[MoEShape] = None

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def elt(self) -> int:
        return torch.empty((), dtype=self.torch_dtype).element_size()


def model_shape(cfg: dict) -> ModelShape:
    """The sizes of a configuration file's model: its published keys, and
    under ``assumed`` ({"value", "why"}) what the source does not give."""
    def given(key, default=None):
        if key in cfg:
            return cfg[key]
        return cfg.get("assumed", {}).get(key, {}).get("value", default)
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    moe = None
    if cfg.get("num_experts"):
        moe = MoEShape(cfg["num_experts"], cfg["num_experts_per_tok"],
                       cfg["moe_intermediate_size"],
                       cfg.get("shared_expert_intermediate_size", 0),
                       bool(cfg["norm_topk_prob"]),
                       float(given("capacity_factor")))
    return ModelShape(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"], d_model=d,
        n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=given("head_dim", d // h), d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        max_positions=cfg["max_position_embeddings"],
        eps=float(cfg["rms_norm_eps"]),
        qkv_bias=bool(cfg.get("bias") or given("qkv_bias", False)),
        dtype=cfg["torch_dtype"], moe=moe)


def layer_leaves(s: ModelShape) -> List[Tuple[str, tuple]]:
    """One layer's weights: (name, shape), products as [in, out]."""
    d, hd = s.d_model, s.head_dim
    out = [("attn_norm", (d,)), ("mlp_norm", (d,)),
           ("wq", (d, s.n_heads * hd)), ("wk", (d, s.n_kv_heads * hd)),
           ("wv", (d, s.n_kv_heads * hd)), ("wo", (s.n_heads * hd, d))]
    if s.qkv_bias:
        out += [("bq", (s.n_heads * hd,)), ("bk", (s.n_kv_heads * hd,)),
                ("bv", (s.n_kv_heads * hd,))]
    m = s.moe
    if m is None:
        return out + [("w_gate", (d, s.d_ff)), ("w_up", (d, s.d_ff)),
                      ("w_down", (s.d_ff, d))]
    out += [("router", (d, m.n_experts)),
            ("e_gate", (m.n_experts, d, m.d_expert)),
            ("e_up", (m.n_experts, d, m.d_expert)),
            ("e_down", (m.n_experts, m.d_expert, d))]
    if m.d_shared:
        out += [("s_gate", (d, m.d_shared)), ("s_up", (d, m.d_shared)),
                ("s_down", (m.d_shared, d)), ("s_gate_proj", (d, 1))]
    return out


def leaves(s: ModelShape) -> List[Tuple[str, tuple]]:
    """Every weight of the model: (name, shape)."""
    out = [("embed", (s.vocab, s.d_model))]
    for i in range(s.n_layers):
        out += [(f"layers.{i}.{n}", shp) for n, shp in layer_leaves(s)]
    return out + [("final_norm", (s.d_model,)),
                  ("lm_head", (s.d_model, s.vocab))]


def seed_for(seed: int, tag: str) -> int:
    """A generator seed for one named draw of a run's ``seed``."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (1 << 63)


def generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, tag))
    return g


def _std(name: str, shape: tuple, s: ModelShape, init: dict) -> float:
    leaf = name.rsplit(".", 1)[-1]
    fan_in = shape[-2] if len(shape) >= 2 else 1
    out_scale = 1.0 / math.sqrt(2 * s.n_layers)
    if leaf == "embed":
        return 1.0
    if leaf in ("wo", "w_down", "e_down", "s_down"):
        return out_scale / math.sqrt(fan_in)
    if leaf == "wk":
        return init.get("key_gain", 1.0) / math.sqrt(fan_in)
    if leaf == "router":
        return 2.0 / math.sqrt(fan_in)
    return 1.0 / math.sqrt(fan_in)


@torch.no_grad()
def make_weights(s: ModelShape, seed: int, device, init: dict
                 ) -> Dict[str, torch.Tensor]:
    """Every weight as a view of one buffer in the served dtype, drawn on
    ``device`` from ``seed`` with one generator call (see the module's
    docstring for the distribution)."""
    specs = leaves(s)
    offs, total = [], 0
    for _, shp in specs:
        offs.append(total)
        total += -(-math.prod(shp) // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=s.torch_dtype, device=device)
    flat.normal_(0.0, 1.0, generator=generator(device, seed, "weights"))
    w = {}
    for (name, shp), off in zip(specs, offs):
        t = flat[off:off + math.prod(shp)].view(shp)
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm"):
            t.mul_(0.1).add_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            t.mul_(BIAS)
        else:
            t.mul_(_std(name, shp, s, init))
        w[name] = t
    tie = init.get("self_key_gain", 0.0)
    if tie:
        for i in range(s.n_layers):
            _tie_keys(s, w, f"layers.{i}.", tie)
    return w


def _tie_keys(s: ModelShape, w: dict, pre: str, gain: float) -> None:
    """wk (and bk) of KV head j := gain · wq (bq) of query head j·G."""
    d, hkv, g, hd = s.d_model, s.n_kv_heads, s.group, s.head_dim
    q = w[pre + "wq"].view(d, hkv, g, hd)[:, :, 0, :]
    w[pre + "wk"].view(d, hkv, hd).copy_(q * gain)
    if s.qkv_bias:
        bq = w[pre + "bq"].view(hkv, g, hd)[:, 0, :]
        w[pre + "bk"].view(hkv, hd).copy_(bq * gain)
