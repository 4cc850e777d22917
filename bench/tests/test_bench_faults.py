"""A whole run with the look for a chip skipped, at a tiny size on the
CPU: sound, it comes out correct; with the timed path broken underneath
(a fault planted in ``repro_torch``), ``correct`` comes out false, once
for each fault the cell can have.  The control (the reference in float8
in the program's place) fails the tiny limits too."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_run
from harness import manifest
from harness.weights import model_shape
from repro_torch.models import transformer as T


@pytest.mark.parametrize("cell", ["tiny.decode", "tiny.prefill",
                                  "tiny.moe"])
def test_sound_run_is_correct(tiny_root, cell):
    out = tiny_run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]["setup_s"]["value"] > 0


def _stale_state(orig):
    """Each decode step leaves the cache (K, V, length) as it found it."""
    def step(model, cache, tokens, dtype=None):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, cache = orig(model, cache, tokens, dtype)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache
    return step


def _half_batch(orig):
    """The second half of the slots gets the first half's logits."""
    def step(model, cache, tokens, dtype=None):
        logits, cache = orig(model, cache, tokens, dtype)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, cache
    return step


def _altered_token(orig):
    """Slot 0's token is another one than the step computed."""
    def step(model, cache, tokens, dtype=None):
        logits, cache = orig(model, cache, tokens, dtype)
        logits = logits.clone()
        top = int(logits[0].argmax())
        logits[0, (top + 1) % logits.shape[1]] = logits[0, top] + 1
        return logits, cache
    return step


@pytest.mark.parametrize("fault", [_stale_state, _half_batch,
                                   _altered_token])
def test_decode_faults_are_not_correct(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(T, "decode_step", fault(T.decode_step))
    out = tiny_run(tiny_root, "tiny.decode")
    assert not out["correct"], out["checks"]


def _stale_prefill(orig):
    """Every call returns the first call's logits."""
    first = []

    def prefill(model, tokens):
        if not first:
            first.append(orig(model, tokens))
        return first[0]
    return prefill


def _half_prompts(orig):
    """The second half of the prompts gets the first half's logits."""
    def prefill(model, tokens):
        h = tokens.shape[0] // 2
        out = orig(model, tokens[:h])
        return torch.cat([out, out])
    return prefill


def _altered_first_token(orig):
    """One position's first token is another one."""
    def prefill(model, tokens):
        out = orig(model, tokens).clone()
        top = int(out[0, 5].argmax())
        out[0, 5, (top + 1) % out.shape[-1]] = out[0, 5, top] + 1
        return out
    return prefill


@pytest.mark.parametrize("cell,fault", [
    ("tiny.prefill", _stale_prefill), ("tiny.prefill", _altered_first_token),
    ("tiny.moe", _stale_prefill), ("tiny.moe", _half_prompts),
    ("tiny.moe", _altered_first_token)])
def test_prefill_faults_are_not_correct(tiny_root, monkeypatch, cell, fault):
    monkeypatch.setattr(T, "prefill", fault(T.prefill))
    out = tiny_run(tiny_root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["tiny.decode", "tiny.prefill",
                                  "tiny.moe"])
def test_control_fails_the_limits(tiny_root, cell):
    """The float8 reference in the program's place reads past a limit on
    every seed tried; the program's own readings on the same seeds pass."""
    from harness.check import verdict
    man = manifest.load(tiny_root)
    c = manifest.cell(man, cell)
    shape = model_shape(manifest.config(tiny_root, man, c["config"]))
    bench = tiny_root / "bench"
    mix = manifest.mix(c["traffic"], bench)
    lims = manifest.limits(cell, bench)
    for seed in (1, 2, 3):
        drv = manifest.driver(mix["kind"], bench)(shape, mix, seed, "cpu")
        drv.setup()
        drv.window(0.2)
        drv.release()
        got = drv.check(control=True)
        assert verdict(got["program"], lims)[0], got
        assert not verdict(got["control"], lims)[0], got
