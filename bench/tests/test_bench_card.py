"""The tiny cells on a CUDA card, traced: a whole run through the
profiler's reduction, and the port's kernel in the decode cell.  Skips
without a card; on one, run with ``-m cuda``."""

from __future__ import annotations

import pytest
import torch

from harness import core


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.decode", "tiny.prefill",
                                  "tiny.moe"])
def test_tiny_cell_traced_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = core.run(tiny_root, cell, 5, 0.5, True, bench=tiny_root / "bench")
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
    for m in out["metrics"].values():
        assert m["value"] == m["value"]
    if cell == "tiny.decode":
        assert "gqa_decode_roofline.decode" in out["metrics"]
