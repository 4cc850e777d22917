"""The plain reference against ``repro_torch`` at a tiny size on the CPU,
both in float32 over the benchmark's own weights: a prefill's logits
(blocked and unblocked attention, dense and MoE), and a decode over a
drawn context replayed as the check replays it."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from harness import program
from harness.weights import MoEShape, ModelShape, make_weights
from reference.model import Reference, fp8_round

DENSE = ModelShape(name="tiny", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                   rope_theta=1e6, max_positions=512, eps=1e-6,
                   qkv_bias=False, dtype="float32")
MOE = dataclasses.replace(DENSE, n_kv_heads=4, qkv_bias=True,
                          moe=MoEShape(n_experts=8, top_k=2, d_expert=32,
                                       d_shared=64, norm_topk=False,
                                       capacity_factor=4.0))
DROPS = dataclasses.replace(MOE, moe=dataclasses.replace(
    MOE.moe, capacity_factor=1.0))
INIT = {"key_gain": 3.0}


@pytest.mark.parametrize("shape,chunk", [(DENSE, 0), (DENSE, 32),
                                         (MOE, 0)])
def test_prefill_logits_match(shape, chunk):
    """Equal to float32 rounding; the MoE at capacity factor E / k, where
    nothing is dropped."""
    w = make_weights(shape, 3, "cpu", INIT)
    model = program.build_model(shape, w, "cpu", chunk)
    tokens = torch.randint(0, shape.vocab, (2, 96),
                           generator=torch.Generator().manual_seed(0))
    got = program.prefill(model, tokens)
    ref = Reference(shape, w)
    hid, dropped = ref.forward([{"tokens": t, "pos0": 0} for t in tokens])
    want = torch.stack([ref.head(h) for h in hid])
    assert dropped == 0
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_reference_moe_adds_every_assignment_that_has_a_slot():
    """At capacity factor 1 experts overflow: the reference drops each
    assignment past its expert's capacity (slot-major, tokens in order)
    and adds every other one, as a token-by-token sum does."""
    s = DROPS
    w = make_weights(s, 3, "cpu", INIT)
    lw = Reference(s, w)._layer_weights(0)
    h = torch.randn(96, s.d_model, generator=torch.Generator().manual_seed(2))
    ref = Reference(s, w)
    got, dropped = ref._moe(h, lw)
    m = s.moe
    probs = torch.softmax(h @ lw["router"], dim=-1)
    top_p, top_e = probs.topk(m.top_k, dim=-1)
    cap = -(-h.shape[0] * m.top_k // m.n_experts)
    seen = [0] * m.n_experts
    want = torch.sigmoid(h @ lw["s_gate_proj"]) * ref._swiglu(
        h, lw["s_gate"], lw["s_up"], lw["s_down"])
    lost = 0
    for j in range(m.top_k):
        for t in range(h.shape[0]):
            e = int(top_e[t, j])
            seen[e] += 1
            if seen[e] > cap:
                lost += 1
                continue
            want[t] += top_p[t, j] * ref._swiglu(
                h[t], lw["e_gate"][e], lw["e_up"][e], lw["e_down"][e])
    assert dropped == lost > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_decode_replay_matches_decode_steps():
    s, slots, cache = DENSE, 3, 64
    init = {"self_key_gain": 1.5, "context_key_std": 3.0,
            "context_value_std": 1.0}
    mix = {"init": init}
    from drivers.decode import draw_context
    w = make_weights(s, 5, "cpu", init)
    server = program.decode_server(program.build_model(s, w, "cpu"), slots,
                                   cache, "cpu")
    for i in range(s.n_layers):
        draw_context(server.cache["k"][i], server.cache["v"][i], mix, 5, i)
    context = torch.tensor([40, 45, 50], dtype=torch.int32)
    server.cache["length"].copy_(context)
    tok = torch.tensor([1, 2, 3])
    steps, served = [], []
    for _ in range(6):
        logits = server.step(tok)
        steps.append(logits)
        tok = logits.argmax(-1)
        served.append(tok)
    served = torch.stack(served)                     # [steps, slots]
    ref = Reference(s, make_weights(s, 5, "cpu", init))
    shape = (slots, cache, s.n_kv_heads, s.head_dim)

    def ctx(layer):
        k, v = torch.empty(shape), torch.empty(shape)
        draw_context(k, v, mix, 5, layer)
        return k, v
    seqs = [{"tokens": torch.cat([torch.tensor([b + 1]), served[:-1, b]]),
             "pos0": int(context[b]), "slot": b} for b in range(slots)]
    hid, _ = ref.forward(seqs, ctx)
    for b in range(slots):
        want = ref.head(hid[b])
        got = torch.stack([x[b] for x in steps])
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_fp8_round_keeps_scale_and_loses_precision():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    y = fp8_round(x, 0)
    assert torch.allclose(x.abs().amax(0), y.abs().amax(0), rtol=1e-6)
    err = ((y - x).norm() / x.norm()).item()
    assert 0.005 < err < 0.06
    assert torch.equal(fp8_round(y, 0), y)


def test_weights_regenerate_bit_for_bit():
    a = make_weights(MOE, 11, "cpu", INIT)
    b = make_weights(MOE, 11, "cpu", INIT)
    c = make_weights(MOE, 12, "cpu", INIT)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    tied = make_weights(DENSE, 11, "cpu", {"self_key_gain": 1.5})
    wq = tied["layers.0.wq"].view(64, 2, 2, 16)[:, :, 0]
    assert torch.equal(tied["layers.0.wk"].view(64, 2, 16), wq * 1.5)
    assert np.isclose(float(a["layers.0.router"].std()), 2 / 8, rtol=0.1)
