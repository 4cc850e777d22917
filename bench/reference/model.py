"""Plain float32 reference of the benchmark's transformer LMs.

Dense GQA (InternLM2) and sparse-expert (Qwen2-MoE) decoder layers as the
published modelling code writes them: pre-norm RMSNorm, rotate-half RoPE,
causal GQA attention with an optional q/k/v bias, a SwiGLU MLP or top-k
routed experts with a sigmoid-gated shared expert, a final norm and an
untied head.  Everything is computed in float32 with TF32 off, layer by
layer and in blocks of query rows, so a full-width model fits beside the
card's other work.  It imports nothing of the program under test: it is
handed the benchmark's own weights (``harness.weights``) and, for decode,
the benchmark's synthetic context rows.

``mode="fp8"`` is the control, the precision below the configuration's
bfloat16 as a deployment in fp8 runs it: every linear layer's weight
(per output column) and input (per row) rounded to float8 e4m3 with a
scale, and attention's q, k and v (per position and head) and its
probabilities (per row) before their products, as an fp8 attention
kernel takes them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3 value
SCORE_BYTES = 1 << 31    # float32 scores held at once by one attention block


def no_tf32() -> None:
    """Full float32 products: TF32 would put the reference a precision
    below the program it judges."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Linear:
    """``x @ w`` in float32, or with both sides rounded to fp8."""

    def __init__(self, mode: str):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision mode {mode!r}")
        self.mode = mode

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()          # [in, out] or an expert stack [E, in, out]
        return fp8_round(w, -2) if self.mode == "fp8" else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp8":
            x = fp8_round(x, -1)
        return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) [n, head_dim / 2] in float32 for integer ``positions``,
    the angles worked out in float64."""
    inv = 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                          / head_dim)
    ang = np.outer(positions.cpu().numpy().astype(np.float64), inv)
    dev = positions.device
    return (torch.from_numpy(np.cos(ang)).float().to(dev),
            torch.from_numpy(np.sin(ang)).float().to(dev))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [n, heads, hd] rotated by rotate-half RoPE at its rows' angles."""
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              offset: int, fp8: bool = False) -> torch.Tensor:
    """Causal GQA attention of n queries [n, H, hd] against m keys and
    values [m, Hkv, hd], query i at key position ``offset + i`` (it sees
    keys 0 .. offset + i).  Blocks of query rows keep the scores under
    SCORE_BYTES.  ``fp8`` rounds q, k, v and the probabilities to e4m3
    before their products."""
    if fp8:
        q, k, v = fp8_round(q, -1), fp8_round(k, -1), fp8_round(v, -1)
    n, h, hd = q.shape
    m, hkv = k.shape[0], k.shape[1]
    g = h // hkv
    qg = q.view(n, hkv, g, hd).permute(1, 2, 0, 3)          # [Hkv, G, n, hd]
    kt = k.permute(1, 2, 0)                                  # [Hkv, hd, m]
    vt = v.permute(1, 0, 2)                                  # [Hkv, m, hd]
    scale = 1.0 / math.sqrt(hd)
    rows = max(1, SCORE_BYTES // (4 * h * m))
    keys = torch.arange(m, device=q.device)
    out = []
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        s = torch.matmul(qg[:, :, lo:hi], kt[:, None]) * scale
        seen = keys[None, :] <= (offset + torch.arange(lo, hi,
                                                       device=q.device))[:, None]
        s = s.masked_fill(~seen, float("-inf"))
        p = torch.softmax(s, dim=-1)
        if fp8:
            p = fp8_round(p, -1)
        out.append(torch.matmul(p, vt[:, None]))            # [Hkv, G, r, hd]
    o = torch.cat(out, dim=2)
    return o.permute(2, 0, 1, 3).reshape(n, h * hd)


class Reference:
    """The model of config ``shape`` over the weights ``w`` (a mapping of
    the benchmark's leaf names to tensors, any dtype), in ``mode``."""

    def __init__(self, shape, w: Dict[str, torch.Tensor], mode: str = "fp32"):
        self.s = shape
        self.w = w
        self.lin = Linear(mode)
        self._head = None

    def _layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        pre = f"layers.{i}."
        out = {}
        for name, t in self.w.items():
            if not name.startswith(pre):
                continue
            leaf = name[len(pre):]
            if leaf.startswith(("w", "e_", "s_", "router")):
                out[leaf] = self.lin.weight(t)
            else:
                out[leaf] = t.float()
        return out

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["embed"][tokens].float()

    def attn_block(self, x: torch.Tensor, lw, positions: torch.Tensor,
                   prefix=None) -> torch.Tensor:
        """x [n, d] of one sequence at ``positions`` (consecutive), with
        ``prefix`` (k, v) [p, Hkv, hd] before it: x + attention."""
        s = self.s
        h = rms_norm(x, lw["attn_norm"], s.eps)
        q, k, v = (self.lin(h, lw["wq"]), self.lin(h, lw["wk"]),
                   self.lin(h, lw["wv"]))
        if s.qkv_bias:
            q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
        n = x.shape[0]
        cos, sin = rope_table(positions, s.head_dim, s.rope_theta)
        q = rope(q.view(n, s.n_heads, s.head_dim), cos, sin)
        k = rope(k.view(n, s.n_kv_heads, s.head_dim), cos, sin)
        v = v.view(n, s.n_kv_heads, s.head_dim)
        off = 0
        if prefix is not None:
            pk, pv = prefix
            off = pk.shape[0]
            k = torch.cat([pk.float(), k])
            v = torch.cat([pv.float(), v])
        o = attention(q, k, v, off, self.lin.mode == "fp8")
        return x + self.lin(o, lw["wo"])

    def mlp_block(self, x: torch.Tensor, lw) -> torch.Tensor:
        """x [T, d] (every token of the call, in the program's order):
        x + MLP, and the routed assignments dropped past capacity."""
        s = self.s
        h = rms_norm(x, lw["mlp_norm"], s.eps)
        if s.moe is None:
            return x + self._swiglu(h, lw["w_gate"], lw["w_up"],
                                    lw["w_down"]), 0
        y, dropped = self._moe(h, lw)
        return x + y, dropped

    def _swiglu(self, h, wg, wu, wd):
        return self.lin(F.silu(self.lin(h, wg)) * self.lin(h, wu), wd)

    def _moe(self, h: torch.Tensor, lw):
        """Top-k routing over softmax(h @ router) with a capacity of
        ceil(T·k / E · capacity_factor) slots an expert: assignments are
        placed slot-major (all tokens' first choices, then their second,
        ...), tokens in order, and one past its expert's last slot is
        dropped; every assignment that has a slot is computed and added.
        At a capacity factor of E / k or more every expert has a slot for
        every token and nothing is dropped, as in the published model.
        The shared expert is scaled by sigmoid(h @ gate)."""
        m = self.s.moe
        t = h.shape[0]
        probs = torch.softmax(self.lin(h, lw["router"]), dim=-1)
        # the k largest, ties to the lower expert
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_e = order.values[:, :m.top_k], order.indices[:, :m.top_k]
        if m.norm_topk:
            top_p = top_p / top_p.sum(-1, keepdim=True)
        cap = max(int(math.ceil(t * m.top_k / m.n_experts
                                * m.capacity_factor)), 1)
        flat_e = top_e.t().reshape(-1)                       # slot-major
        flat_p = top_p.t().reshape(-1)
        flat_t = torch.arange(t, device=h.device).repeat(m.top_k)
        y = torch.zeros_like(h)
        dropped = 0
        for e in range(m.n_experts):
            sel = (flat_e == e).nonzero()[:, 0]
            dropped += sel[cap:].numel()
            sel = sel[:cap]
            if sel.numel() == 0:
                continue
            tok = flat_t[sel]
            out = self._swiglu(h[tok], lw["e_gate"][e], lw["e_up"][e],
                               lw["e_down"][e])
            y.index_add_(0, tok, out * flat_p[sel, None])
        gate = torch.sigmoid(self.lin(h, lw["s_gate_proj"]))
        y = y + gate * self._swiglu(h, lw["s_gate"], lw["s_up"],
                                    lw["s_down"])
        return y, int(dropped)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head of hidden rows [r, d]: logits [r, V]."""
        if self._head is None:
            self._head = self.lin.weight(self.w["lm_head"])
        return self.lin(rms_norm(x, self.w["final_norm"], self.s.eps),
                        self._head)

    def forward(self, seqs: Sequence[dict],
                context: Optional[Callable[[int], tuple]] = None):
        """Hidden states after the last layer of every sequence in
        ``seqs``, and the routed assignments dropped in all layers.

        Each sequence is {"tokens": [n] ids, "pos0": its first position,
        "slot": the context row it continues (decode) or None}.  Where
        ``context`` is given, ``context(layer)`` returns that layer's
        (k, v) [slots, S, Hkv, hd]; a sequence at ``pos0`` then attends to
        its slot's first ``pos0`` rows before its own.  The MLP or MoE
        block runs on the tokens of all sequences together, in order, as
        one forward call of the program does."""
        xs = [self.embed(sq["tokens"]) for sq in seqs]
        pos = [torch.arange(sq["pos0"], sq["pos0"] + len(sq["tokens"]),
                            device=xs[0].device) for sq in seqs]
        dropped = 0
        for i in range(self.s.n_layers):
            lw = self._layer_weights(i)
            ctx = context(i) if context is not None else None
            for j, sq in enumerate(seqs):
                prefix = None
                if ctx is not None and sq.get("slot") is not None:
                    b, p0 = sq["slot"], sq["pos0"]
                    prefix = (ctx[0][b, :p0], ctx[1][b, :p0])
                xs[j] = self.attn_block(xs[j], lw, pos[j], prefix)
            del ctx
            sizes = [x.shape[0] for x in xs]
            y, d = self.mlp_block(torch.cat(xs), lw)
            dropped += d
            xs = list(torch.split(y, sizes))
            del lw
        return xs, dropped
