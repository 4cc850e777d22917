"""The one generator of every traffic mix (``bench/traffic/<mix>.json``).

A mix is parameters only, with the ``source`` its lengths come from; its
``kind`` names the driver that serves it (``bench/drivers/<kind>.py``).
Every seed gets the same set of sizes in another order, so two seeds ask
for the same work: context lengths at evenly spaced points of their
range, answer lengths from a fixed pool, both permuted by the seed; token
ids are drawn from the seed.

Decode mixes (``kind: "decode"``): ``slots`` sequences decode together
against one cache of ``cache_positions``; slot b's retrieved context is
``context[b]`` positions long (in ``context_tokens``); each answer starts
from a question token and runs for its answer length (in
``answer_tokens``, capped where it would pass the cache's end), then the
slot starts a new answer over the same context.  With ``stagger`` the
slots' first answers are cut to evenly spaced lengths from 1 to the
longest answer, permuted by the seed, as in a server whose slots began
their answers at different times: the slots then restart at different
steps.

Prefill mixes (``kind: "prefill"``): each call is ``batch`` prompts of
``prompt_tokens`` ids, the i-th call's drawn from the seed and i, so no
prompt comes twice however many calls a window holds.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .weights import generator, seed_for

ANSWER_POOL = 16         # answer lengths in a decode mix's pool


def spaced(lo: int, hi: int, n: int) -> np.ndarray:
    """n integers at the midpoints of n equal parts of [lo, hi]."""
    return (lo + (np.arange(n) + 0.5) * (hi - lo) / n).astype(np.int64)


@dataclasses.dataclass
class DecodeSchedule:
    """Slot b's context length ``context[b]``; its k-th answer's length
    ``answers[b][k]`` and question token ``questions[b][k]``."""
    context: np.ndarray
    answers: List[List[int]]
    questions: List[List[int]]
    rng: np.random.Generator
    pool: np.ndarray
    cache: int
    vocab: int

    def answer(self, b: int, k: int):
        """(length, question token) of slot b's k-th answer."""
        while k >= len(self.answers[b]):
            cap = self.cache - int(self.context[b])
            self.answers[b] += [int(min(a, cap))
                                for a in self.rng.permutation(self.pool)]
            self.questions[b] += self.rng.integers(
                0, self.vocab, len(self.pool)).tolist()
        return self.answers[b][k], self.questions[b][k]


def decode_schedule(mix: dict, seed: int, vocab: int) -> DecodeSchedule:
    rng = np.random.default_rng(seed_for(seed, "traffic"))
    b = mix["slots"]
    lo, hi = mix["context_tokens"]
    context = rng.permutation(spaced(lo, hi, b))
    if context.max() >= mix["cache_positions"]:
        raise ValueError("a context fills the whole cache")
    pool = spaced(*mix["answer_tokens"], ANSWER_POOL)
    sched = DecodeSchedule(context, [[] for _ in range(b)],
                           [[] for _ in range(b)], rng, pool,
                           mix["cache_positions"], vocab)
    if mix.get("stagger"):
        first = rng.permutation(spaced(1, int(pool.max()), b))
        for i in range(b):
            sched.answer(i, 0)
            sched.answers[i][0] = int(min(first[i], sched.answers[i][0]))
    return sched


def prefill_prompt(mix: dict, seed: int, vocab: int, device, call: int
                   ) -> torch.Tensor:
    """The ``call``-th call's [batch, prompt_tokens] int64 ids on
    ``device`` (call -1: the warm-up's)."""
    shape = (mix["batch"], mix["prompt_tokens"])
    return torch.randint(0, vocab, shape, device=device,
                         generator=generator(device, seed, f"prompt-{call}"))
