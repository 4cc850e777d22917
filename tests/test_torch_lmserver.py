"""The port's ``LMServer`` against ``repro.train.serve.LMServer``.

Both serve the same weights (the JAX init, carried across by
``convert.transformer_from_jax``) on the ``internlm2-1.8b`` smoke config
in float32, and on the ``qwen2-moe-a2.7b`` smoke config and a
``qwen3-moe-235b-a22b`` smoke config with 16 query heads on 1 KV head
(the full config's G = 16), whose 4 slots give a capacity of 3 a decode
step that binds.  Every step's logits must
agree at rtol/atol 2e-4 (as in ``tests/test_torch_transformer.py``), and
the greedy tokens must be equal; equal tokens are a sound check only
where no argmax could flip, so the test also asserts that every used
step's top-2 logit gap in the JAX run exceeds 100× that tolerance (dense)
or twice the row's measured |Δ| between the two servers, which is what
an argmax needs to agree (MoE: its smoke model's gaps go down to 0.008).
"""

import dataclasses
import importlib
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the repository root's card script)
from repro.configs import get_arch  # noqa: E402
from repro.train.serve import LMServer as JaxLMServer  # noqa: E402
from repro_torch.configs.lm_family import get_config  # noqa: E402
from repro_torch.convert import transformer_from_jax  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve import LMServer  # noqa: E402

TOL = 2e-4
PROMPTS = [[5, 9, 2, 11, 40], [7, 4], [300, 1, 2]]


def _recording(fn, log, pick):
    def wrapped(*args):
        out = fn(*args)
        log.append(np.asarray(pick(out), np.float32).copy())
        return out
    return wrapped


# a smoke config with its overrides on both packages' configs: Qwen3-MoE
# with 16 query heads on 1 KV head, the full config's G = 16
VARIANTS = {"qwen3-moe-g16": ("qwen3-moe-235b-a22b", dict(
    name="qwen3-moe-g16-smoke", n_heads=16, n_kv_heads=1))}


def _servers(seed=0, max_slots=4, max_len=16, arch="internlm2-1.8b"):
    arch, over = VARIANTS.get(arch, (arch, {}))
    spec = get_arch(arch)
    jcfg = dataclasses.replace(spec.smoke_config, dtype="float32", **over)
    params = spec.init_fn(jcfg, jax.random.PRNGKey(seed))
    model = transformer_from_jax(jax.tree.map(np.asarray, params),
                                 dataclasses.replace(
                                     get_config(arch, smoke=True), **over),
                                 device="cpu")
    return (JaxLMServer(params, jcfg, max_slots=max_slots, max_len=max_len),
            LMServer(model, max_slots=max_slots, max_len=max_len,
                     device="cpu"))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b",
                                  "qwen3-moe-g16"])
def test_generate_matches_jax_server(arch):
    jserver, tserver = _servers(arch=arch)
    dispatches = []
    jlog, tlog = [], []
    jserver.step_fn = _recording(jserver.step_fn, jlog, lambda o: o[0])
    tserver.step = _recording(tserver.step, tlog,
                              lambda o: o.detach().numpy())
    want = jserver.generate(PROMPTS, max_new=6)
    with chip_smoke.recorded_dispatches(dispatches):
        got = tserver.generate(PROMPTS, max_new=6)
    drops = [int((~keep).sum()) for *_, keep, _ in dispatches]
    assert len(jlog) == len(tlog) == max(map(len, PROMPTS)) + 6
    for i, (j, t) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")
        for s, p in enumerate(PROMPTS):
            if i >= len(p) - 1:          # the argmax is used from here on
                top2 = np.sort(j[s])[-2:]
                need = (100 * TOL if tserver.cfg.moe is None
                        else 2 * float(np.abs(t[s] - j[s]).max()))
                assert top2[1] - top2[0] > need, (i, s, top2, need)
    assert got == want
    assert all(len(o) == 6 for o in got)
    if tserver.cfg.moe is None:
        assert not drops
    else:                               # capacity binds, T = 4 slots
        assert TT.capacity(4, tserver.cfg.moe) == 3 and sum(drops) > 0


def test_two_calls_give_the_same_tokens():
    """A fresh KV cache on every call (the reference's two-call fix)."""
    _, server = _servers(seed=1)
    first = server.generate(PROMPTS, max_new=4)
    cache = server.cache
    second = server.generate(PROMPTS, max_new=4)
    assert first == second
    assert server.cache is not cache


def test_slots_beyond_the_prompts_and_too_many_prompts():
    _, server = _servers(max_slots=4)
    out = server.generate([[1, 2, 3]], max_new=3)
    assert len(out) == 1 and len(out[0]) == 3
    with pytest.raises(ValueError, match="slots"):
        server.generate([[1]] * 5, max_new=1)


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` means CUDA: without a card the server raises rather
    than run on the CPU."""
    model = init_params(get_config("internlm2-1.8b", smoke=True),
                        torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMServer(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--mode", "lm", "--tokens", "2"])


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen2-moe-a2.7b"])
def test_launcher_lm_mode_on_the_cpu(capsys, arch):
    launch_serve.main(["--mode", "lm", "--arch", arch,
                       "--tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decoded 12 tokens for 4 sequences on cpu" in out
    assert out.count("prompt [") == 4


def test_chip_smoke_lm_phases_on_the_cpu():
    """``chip_smoke.py``'s phases 10 and 11 on the CPU, at a bfloat16 smoke
    config: their checks hold with the plain version (no launches), and
    the fp8-weight decode falls outside the logit tolerance."""
    cpu = torch.device("cpu")
    assert chip_smoke.phase_decode_small(cpu) == 0.0
    cfg = dataclasses.replace(get_config("qwen2.5-14b", smoke=True),
                              dtype="bfloat16")
    row = chip_smoke.phase_lm_serve(cpu, cfg=cfg, slots=4, max_len=64,
                                    lens=(8, 24), max_new=8)
    assert row["tokens_equal"]
    assert [c["launches"] for c in row["calls"]] == [0, 0]
    assert row["fp8_weights_vs_f32"]["mean_abs"] > row["mean_abs_tol"]


@pytest.mark.parametrize("wrong", ["last_quarter", "zeros"])
def test_chip_smoke_deploy_check_sees_every_position(monkeypatch, wrong):
    """Phase 12's comparison at deployment lengths passes the plain version
    and refuses a kernel that reads only the last quarter of the positions
    (as one that skipped every split but the last would), or returns
    zeros: with K and V from the seed every position carries weight."""
    pkg = importlib.import_module("repro_torch.kernels.gqa_decode")
    gen = torch.Generator().manual_seed(0)
    b, s, hkv, g, d = 2, 4096, 2, 5, 128
    q = torch.randn((b, hkv, g, d), generator=gen).bfloat16()
    k, v = (torch.randn((b, s, hkv, d), generator=gen).bfloat16()
            for _ in range(2))
    length = torch.tensor([s, 3000], dtype=torch.int32)
    assert chip_smoke.check_deploy("cpu", q, k, v, length) == 0.0
    ref = pkg.gqa_decode_ref
    lo = 3 * s // 4
    bad = {"last_quarter": lambda q, k, v, n: ref(
               q, k[:, lo:].contiguous(), v[:, lo:].contiguous(),
               (n - lo).clamp(min=0)),
           "zeros": lambda q, k, v, n: torch.zeros_like(q)}[wrong]
    monkeypatch.setattr(pkg, "gqa_decode", bad)
    with pytest.raises(AssertionError, match="from the plain version"):
        chip_smoke.check_deploy("cpu", q, k, v, length)


@pytest.mark.parametrize("single_bf16", [False, True],
                         ids=["p_hi_plus_lo", "p_single_bf16"])
def test_chip_smoke_conditioned_check_sees_single_bf16_p(monkeypatch,
                                                         single_bf16):
    """Phase 11's conditioned check at a bfloat16 smoke size, with the mma
    kernel's arithmetic (``emulate_mma``) in place of the decode's
    attention (the reference decode takes the plain version): P split
    into bf16 hi + lo passes it; P rounded once to bf16 fails it, and so
    do the check's own controls (the plain version with P rounded once to
    bf16, an fp8-weight decode)."""
    from test_torch_gqa_decode import emulate_mma
    gqa = importlib.import_module("repro_torch.kernels.gqa_decode.kernel")
    monkeypatch.setattr(gqa, "gqa_decode", lambda q, k, v, n: emulate_mma(
        q, k, v, n, single_bf16=single_bf16))
    cfg = dataclasses.replace(get_config("qwen2.5-14b", smoke=True),
                              dtype="bfloat16")
    prompts = chip_smoke.rag_prompts(cfg.vocab, 4, (64, 200))

    def check():
        return chip_smoke.conditioned_check(torch.device("cpu"), cfg,
                                            prompts, 4, 256, 8)
    if single_bf16:
        with pytest.raises(AssertionError, match="conditioned decode"):
            check()
    else:
        row = check()
        assert row["ratio"] <= chip_smoke.COND_RATIO \
            < min(row["single_bf16_p_ratio"], row["fp8_ratio"])
