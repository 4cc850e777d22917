"""Prefill cells: one forward of ``batch`` prompts of ``prompt_tokens`` a
call through ``transformer.prefill``, each call ending with the first
answer token of every prompt (its last position's argmax) on the host.

Set-up draws the weights on the device from the seed and warms up one
call at the cell's shape; each call's prompts are drawn on the device
from the seed and the call's index.  The check takes the last call of
the run: the program's argmax at every position and its logits at a
seeded sample of rows (the last position of each prompt among them),
against the float32 reference's forward over the same prompts.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import check as C
from harness import program
from harness.trace import Spans, profiled
from harness.traffic import prefill_prompt
from harness.weights import make_weights, seed_for
from reference.model import Reference, no_tf32


class Driver:
    def __init__(self, shape, mix: dict, seed: int, device):
        self.s, self.mix, self.seed = shape, mix, seed
        self.dev = torch.device(device)

    def setup(self) -> None:
        s, mix, dev = self.s, self.mix, self.dev
        self.w = make_weights(s, self.seed, dev, mix["init"])
        self.model = program.build_model(s, self.w, dev, mix["attn_chunk"])
        warm = self.prompt(-1)
        for _ in range(mix["warmup_calls"]):
            program.prefill(self.model, warm)[:, -1].argmax(-1).cpu()
        self.calls, self.kept = 0, None
        _sync(dev)

    def prompt(self, call: int) -> torch.Tensor:
        return prefill_prompt(self.mix, self.seed, self.s.vocab, self.dev,
                              call)

    def _calls(self, spans: Spans, until) -> None:
        """Calls until ``until(t)`` holds after one; the last call's
        logits stay (the others are freed before the next call)."""
        while True:
            i = self.calls
            tokens = self.prompt(i)
            with spans("prefill_call"):
                logits = program.prefill(self.model, tokens)
            with spans("argmax_copy"):
                logits[:, -1].argmax(-1).cpu()
            self.calls += 1
            t = time.perf_counter()
            if until(t):
                self.kept = (i, logits)
                return
            del logits

    def window(self, seconds: float) -> dict:
        spans = Spans()
        t0 = time.perf_counter()
        t_end = []
        self._calls(spans, lambda t: t_end.append(t) or t - t0 >= seconds)
        return {"kind": "prefill", "seconds": t_end[-1] - t0,
                "calls": self.calls, "batch": self.mix["batch"],
                "prompt_tokens": self.mix["prompt_tokens"],
                "call_s": np.diff(t_end, prepend=t0),
                "spans": dict(spans.seconds)}

    def traced(self) -> dict:
        self.kept = None                     # the traced calls' last counts
        spans = Spans()
        n0, n = self.calls, self.mix["trace_calls"]
        out = profiled(lambda: self._calls(
            spans, lambda t: self.calls - n0 >= n))
        out["calls"] = n
        return out

    def release(self) -> None:
        i, logits = self.kept
        self.checked = self.prompt(i)
        b, s, v = logits.shape
        self.argmax = logits.argmax(-1).cpu()                    # [B, S]
        rng = np.random.default_rng(seed_for(self.seed, "check"))
        rows = rng.choice(b * s, size=self.mix["rows_checked"], replace=False)
        rows = np.unique(np.concatenate([rows, np.arange(1, b + 1) * s - 1]))
        self.rows = torch.as_tensor(rows)
        self.rows_logits = logits.reshape(b * s, v)[
            self.rows.to(logits.device)].float().cpu()
        self.tokens_attempted = self.calls * b * s
        del logits, self.kept, self.model, self.w
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """{"program": readings} (and {"control": ...}) against the
        float32 reference; see the module's docstring."""
        no_tf32()
        s, dev = self.s, self.dev
        w = make_weights(s, self.seed, dev, self.mix["init"])
        seqs = [{"tokens": t, "pos0": 0} for t in self.checked]
        prog_arg = self.argmax.reshape(-1)
        rows = self.rows.to(dev)
        hid8 = None
        if control:
            ref8 = Reference(s, w, "fp8")
            hid8 = torch.cat(ref8.forward(seqs)[0])
        ref = Reference(s, w, "fp32")
        hid, dropped = ref.forward(seqs)
        hid = torch.cat(hid)
        gaps, ctrl_gaps, ref_rows, ctrl_rows = C.Gaps(), C.Gaps(), [], []
        block = 4096
        for lo in range(0, hid.shape[0], block):
            r = ref.head(hid[lo:lo + block])
            hi = lo + r.shape[0]
            gaps.add(r, prog_arg[lo:hi])
            sel = rows[(rows >= lo) & (rows < hi)] - lo
            ref_rows.append(r[sel])
            if control:
                c = ref8.head(hid8[lo:hi])
                ctrl_gaps.add(r, c.argmax(-1))
                ctrl_rows.append(c[sel])
                del c
            del r
        ref_rows = torch.cat(ref_rows)
        out = {"program": {**gaps.readings(), "logit_err": C.logit_err(
                   self.rows_logits, ref_rows)},
               "compared": {"tokens": gaps.rows, "rows": int(rows.numel()),
                            "dropped": int(dropped),
                            "misses": gaps.misses}}
        if control:
            out["control"] = {**ctrl_gaps.readings(), "logit_err":
                              C.logit_err(torch.cat(ctrl_rows), ref_rows)}
            out["compared"]["control_misses"] = ctrl_gaps.misses
        return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
