"""The numbers that decide ``correct``, from reference logits.

``gap``: the widest margin by which a token the program put first lies
below the reference's best logit at the same position (0 where they
agree; a greedy token is judged by what it is, so a near tie that
rounding flips reads small); ``gap_mean``: that margin's mean over every
compared position.  ``logit_err``: the largest relative L2 distance
||program - reference|| / ||reference|| of a compared row of logits.
Each is worked out from float32 blocks, on the reference's device.  A
cell's limits file names the numbers that decide its ``correct``; the
others are reported beside them.
"""

from __future__ import annotations

import torch


class Gaps:
    """The margins ``max(ref[i]) - ref[i, tokens[i]]``, gathered block by
    block: their maximum, mean, and the rows where the token is not the
    reference's first."""

    def __init__(self):
        self.max, self.sum, self.rows, self.misses = 0.0, 0.0, 0, 0

    def add(self, ref: torch.Tensor, tokens: torch.Tensor) -> None:
        t = tokens.to(ref.device).long()
        g = ref.amax(-1) - ref.gather(1, t[:, None])[:, 0]
        if g.numel():
            self.max = max(self.max, float(g.max()))
        self.sum += float(g.double().sum())
        self.rows += g.numel()
        self.misses += int((ref.argmax(-1) != t).sum())

    def readings(self) -> dict:
        return {"gap": self.max, "gap_mean": self.sum / max(self.rows, 1)}


def logit_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ||got[i] - ref[i]|| / ||ref[i]|| over rows [n, V]."""
    got = got.to(ref.device).float()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names: each at most its limit; a cell without limits, or a reading
    missing or not finite, is not correct."""
    out, ok = {}, bool(limits)
    for name, lim in limits.items():
        value = readings.get(name, float("nan"))
        out[name] = {"value": value, "limit": lim["limit"]}
        if not value <= lim["limit"]:
            ok = False
    return ok, out
