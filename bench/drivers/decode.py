"""Decode cells: continuous greedy decoding of ``slots`` answers against
long retrieved contexts, through ``LMServer.step``.

Set-up draws the weights and every layer's context rows (K and V at each
slot's positions, in the served dtype) on the device from the seed, and
warms up the step, the argmax and the refill at the cell's shapes.  Each
step then feeds every slot's last greedy token (or, where an answer has
just ended, the next answer's question token, with the slot's length set
back to its context), and copies the step's argmax to the host: that copy
is the token the slot's client sees.

The check replays every slot's answer in progress at the last step, and
a seeded sample of finished answers with the longest among them, through
the reference: the same context rows (drawn again from the seed), the
question token and the served tokens at their positions, every K and V
row of the answer worked out again.  ``gap`` and ``gap_mean`` are taken
over each replayed served token, ``logit_err`` over the last step's
logits of every slot.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import check as C
from harness import program
from harness.trace import Spans, profiled
from harness.traffic import decode_schedule
from harness.weights import generator, make_weights, seed_for
from reference.model import Reference, no_tf32


def draw_context(k: torch.Tensor, v: torch.Tensor, mix: dict, seed: int,
                 layer: int) -> None:
    """Fill one layer's context rows k, v [slots, S, Hkv, hd] from the
    seed (the same values into any tensors of that shape and dtype)."""
    init = mix["init"]
    k.normal_(0.0, init["context_key_std"],
              generator=generator(k.device, seed, f"context-k-{layer}"))
    v.normal_(0.0, init["context_value_std"],
              generator=generator(v.device, seed, f"context-v-{layer}"))


class Driver:
    def __init__(self, shape, mix: dict, seed: int, device):
        self.s, self.mix, self.seed = shape, mix, seed
        self.dev = torch.device(device)
        self.slots = mix["slots"]

    # ------------------------------------------------------------------ #
    def setup(self) -> None:
        s, mix, dev = self.s, self.mix, self.dev
        self.sched = decode_schedule(mix, self.seed, s.vocab)
        self.w = make_weights(s, self.seed, dev, mix["init"])
        model = program.build_model(s, self.w, dev)
        self.server = program.decode_server(model, self.slots,
                                            mix["cache_positions"], dev)
        cache = self.server.cache
        for i in range(s.n_layers):
            draw_context(cache["k"][i], cache["v"][i], mix, self.seed, i)
        self.context = torch.as_tensor(self.sched.context, dtype=torch.int32,
                                       device=dev)
        self.length = cache["length"]
        # warm-up at the cell's shapes: step, argmax, copy and a refill
        tok = torch.zeros(self.slots, dtype=torch.long, device=dev)
        every = torch.arange(self.slots, device=dev)
        self.length.copy_(self.context)
        for _ in range(mix["warmup_steps"]):
            nxt = self.server.step(tok).argmax(-1)
            nxt.cpu()
            tok = nxt.index_copy(0, every, tok)
            self.length.index_copy_(0, every, self.context)
        # the schedule's first answers
        self.length.copy_(self.context)
        first = [self.sched.answer(b, 0) for b in range(self.slots)]
        self.alen = np.array([a for a, _ in first])
        self.q = np.array([q for _, q in first])
        self.k = np.zeros(self.slots, np.int64)      # answer index
        self.pos = np.zeros(self.slots, np.int64)    # tokens served in it
        self.s0 = np.zeros(self.slots, np.int64)     # its first step
        self.tok = torch.as_tensor(self.q, device=dev)
        self.served, self.t_host, self.finished = [], [], []
        self.logits = None
        _sync(dev)

    def _steps(self, spans: Spans, until) -> None:
        """Decode steps until ``until(t_host)`` holds after a step."""
        while True:
            with spans("step"):
                logits = self.server.step(self.tok)
            with spans("argmax_copy"):
                nxt = logits.argmax(-1)
                host = nxt.cpu().numpy()
            t = time.perf_counter()
            with spans("refill"):
                step = len(self.served)
                self.served.append(host)
                self.t_host.append(t)
                self.pos += 1
                done = np.nonzero(self.pos == self.alen)[0]
                for b in done:
                    self.finished.append(dict(slot=int(b), s0=int(self.s0[b]),
                                              n=int(self.pos[b]),
                                              q=int(self.q[b])))
                    self.k[b] += 1
                    self.alen[b], self.q[b] = self.sched.answer(b, self.k[b])
                    self.pos[b], self.s0[b] = 0, step + 1
                if done.size:
                    idx = torch.as_tensor(done, device=self.dev)
                    q = torch.as_tensor(self.q[done], device=self.dev)
                    self.tok = nxt.index_copy(0, idx, q)
                    self.length.index_copy_(
                        0, idx, self.context.index_select(0, idx))
                else:
                    self.tok = nxt
            self.logits = logits
            if until(t):
                return

    def window(self, seconds: float) -> dict:
        spans = Spans()
        t0 = time.perf_counter()
        self._steps(spans, lambda t: t - t0 >= seconds)
        n = len(self.t_host)
        t = np.array(self.t_host)
        return {"kind": "decode", "seconds": t[-1] - t0, "steps": n,
                "slots": self.slots, "gaps": np.diff(t, prepend=t0),
                "spans": dict(spans.seconds), "attend": self._attend(0, n)}

    def _attend(self, lo: int, hi: int) -> np.ndarray:
        """[steps, slots] positions each step's attention covers (the
        context, the answer so far and the row written in the step)."""
        out = np.zeros((hi - lo, self.slots), np.int64)
        ctx = self.sched.context
        segs = self.finished + self._current()
        for seg in segs:
            b, s0, n = seg["slot"], seg["s0"], seg["n"]
            for j in range(max(s0, lo), min(s0 + n, hi)):
                out[j - lo, b] = ctx[b] + (j - s0) + 1
        return out

    def traced(self) -> dict:
        spans = Spans()
        n0 = len(self.served)
        n = self.mix["trace_steps"]
        out = profiled(lambda: self._steps(
            spans, lambda t: len(self.served) - n0 >= n))
        out["steps"] = n
        out["attend"] = self._attend(n0, n0 + n)
        return out

    # ------------------------------------------------------------------ #
    def _current(self) -> list:
        return [dict(slot=b, s0=int(self.s0[b]), n=int(self.pos[b]),
                     q=int(self.q[b]))
                for b in range(self.slots) if self.pos[b] > 0]

    def release(self) -> None:
        """Keep what the check needs on the host; free the program."""
        last = len(self.served) - 1
        segs = self.finished + self._current()
        self.last = {seg["slot"]: seg for seg in segs
                     if seg["s0"] + seg["n"] - 1 == last}
        done = [seg for seg in segs if seg["s0"] + seg["n"] - 1 < last]
        rng = np.random.default_rng(seed_for(self.seed, "check"))
        pick = []
        if done:
            longest = max(range(len(done)), key=lambda i: done[i]["n"])
            rest = [i for i in range(len(done)) if i != longest]
            more = self.mix["answers_checked"] - 1
            pick = [longest] + list(rng.permutation(rest)[:max(more, 0)])
        self.segments = [self.last[b] for b in sorted(self.last)] + \
            [done[i] for i in pick]
        self.served_np = np.stack(self.served)
        self.last_logits = self.logits.float().cpu()
        self.tokens_attempted = self.served_np.size
        del self.server, self.w, self.logits, self.tok, self.length
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _seqs(self):
        seqs, served = [], []
        for seg in self.segments:
            b, s0, n = seg["slot"], seg["s0"], seg["n"]
            out = self.served_np[s0:s0 + n, b]
            inp = np.concatenate([[seg["q"]], out[:-1]])
            seqs.append({"tokens": torch.as_tensor(inp, device=self.dev),
                         "pos0": int(self.sched.context[b]), "slot": b})
            served.append(torch.as_tensor(out, device=self.dev))
        return seqs, served

    def check(self, control: bool = False) -> dict:
        """{"program": readings} (and {"control": readings}, the fp8
        reference in the program's place) against the float32 reference."""
        no_tf32()
        s, dev = self.s, self.dev
        w = make_weights(s, self.seed, dev, self.mix["init"])
        shape = (self.slots, self.mix["cache_positions"], s.n_kv_heads,
                 s.head_dim)

        def context(layer: int):
            k = torch.empty(shape, dtype=s.torch_dtype, device=dev)
            v = torch.empty(shape, dtype=s.torch_dtype, device=dev)
            draw_context(k, v, self.mix, self.seed, layer)
            return k, v
        seqs, served = self._seqs()
        nlast = len(self.last)
        ctrl_first, ctrl_last = None, None
        if control:
            ref8 = Reference(s, w, "fp8")
            hid, _ = ref8.forward(seqs, context)
            logits8 = [ref8.head(h) for h in hid]
            ctrl_first = [x.argmax(-1) for x in logits8]
            ctrl_last = torch.stack([x[-1] for x in logits8[:nlast]])
            del hid, logits8, ref8
        ref = Reference(s, w, "fp32")
        hid, _ = ref.forward(seqs, context)
        gaps, ctrl_gaps, last = C.Gaps(), C.Gaps(), []
        for i, h in enumerate(hid):
            r = ref.head(h)
            gaps.add(r, served[i])
            if control:
                ctrl_gaps.add(r, ctrl_first[i])
            if i < nlast:
                last.append(r[-1])
            del r
        last = torch.stack(last)
        prog_last = self.last_logits[sorted(self.last)]
        out = {"program": {**gaps.readings(),
                           "logit_err": C.logit_err(prog_last, last)},
               "compared": {"tokens": gaps.rows, "answers": len(seqs),
                            "last_rows": nlast, "misses": gaps.misses}}
        if control:
            out["control"] = {**ctrl_gaps.readings(),
                              "logit_err": C.logit_err(ctrl_last, last)}
            out["compared"]["control_misses"] = ctrl_gaps.misses
        return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
