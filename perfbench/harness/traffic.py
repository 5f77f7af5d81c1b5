"""The one traffic generator: a closed loop of clients, read from a data file.

A traffic file (`perfbench/traffic/<name>.json`) gives:

    clients           concurrent clients; the engine gets as many slots
    prompt_tokens     [lo, hi] prompt lengths
    output_tokens     [lo, hi] generated tokens per request (greedy, no stop
                      tokens, so every request generates exactly this many)
    page_size         KV page size of the engine
    prefill_chunk     prefill chunk of the engine
    settle_steps      engine steps between the first wave's last prefill
                      and the window
    sample_requests   requests live at the window's close whose cached K/V
                      the correctness check compares
    trace_steps       engine steps of the traced slice (`--trace 1`)

Every client sends its next request the moment its last one ends. Lengths
are stratified: in each round (a client's k-th request) the clients'
(prompt, output) pairs are the same fixed set of quantiles of the ranges,
assigned to the clients in a fixed shuffled order. So every seed serves the
same sizes in the same order, and the seed draws only the token ids (and
the weights): the engine's steps, which pack prefill chunks by the order
of the prompts it holds, are the same work for every seed.

The first wave stands for a loop already running: each client's first
request is given an age, a fixed quantile of its output length (paired
with the other quantiles by a fixed low-discrepancy rule); the aged part
joins its prompt (random tokens) and leaves the rest to generate, so the
cache holds a steady state's spread of contexts from the first window
step on.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
ORDER = 20251018        # fixes which client holds which quantile slot


@dataclasses.dataclass
class Traffic:
    clients: int
    prompt_tokens: tuple[int, int]
    output_tokens: tuple[int, int]
    page_size: int
    prefill_chunk: int
    settle_steps: int
    sample_requests: int
    trace_steps: int

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        t = cls(clients=int(d["clients"]),
                prompt_tokens=tuple(int(v) for v in d["prompt_tokens"]),
                output_tokens=tuple(int(v) for v in d["output_tokens"]),
                page_size=int(d["page_size"]),
                prefill_chunk=int(d["prefill_chunk"]),
                settle_steps=int(d["settle_steps"]),
                sample_requests=int(d["sample_requests"]),
                trace_steps=int(d["trace_steps"]))
        for lo, hi in (t.prompt_tokens, t.output_tokens):
            if not 1 <= lo <= hi:
                raise ValueError(f"bad range [{lo}, {hi}]")
        if t.clients < 1:
            raise ValueError("clients must be >= 1")
        return t

    @property
    def max_total(self) -> int:
        return self.prompt_tokens[1] + self.output_tokens[1]


def _van_der_corput(j: int) -> float:
    out, f = 0.0, 0.5
    while j:
        out += f * (j & 1)
        j >>= 1
        f *= 0.5
    return out


def _length(u: float, lo: int, hi: int) -> int:
    return min(hi, lo + int(u * (hi - lo + 1)))


@dataclasses.dataclass
class RequestSpec:
    client: int
    round: int
    prompt: list[int]
    max_new: int


class ClosedLoop:
    """Requests of every client, deterministic in (traffic, vocab, seed)."""

    def __init__(self, traffic: Traffic, vocab: int, seed: int):
        self.t = traffic
        self.vocab = vocab
        self.seed = seed
        self._slots: dict[int, np.ndarray] = {}

    def _slot(self, rnd: int, client: int) -> int:
        """Which quantile slot the client holds in round `rnd`."""
        perm = self._slots.get(rnd)
        if perm is None:
            perm = np.random.default_rng([ORDER, rnd]).permutation(
                self.t.clients)
            self._slots[rnd] = perm
            if len(self._slots) > 8:
                self._slots.pop(min(self._slots))
        return int(perm[client])

    def sizes(self, rnd: int, client: int) -> tuple[int, int, int]:
        """(prompt length, output length, age) of a client's request."""
        n = self.t.clients
        j = self._slot(rnd, client)
        u_out = (j + 0.5) / n
        u_prompt = ((j + 0.5) * GOLDEN + 0.5 * rnd) % 1.0
        p = _length(u_prompt, *self.t.prompt_tokens)
        o = _length(u_out, *self.t.output_tokens)
        age = int(_van_der_corput(j) * o) if rnd == 0 else 0
        return p, o, min(age, o - 1)

    def request(self, rnd: int, client: int) -> RequestSpec:
        p, o, age = self.sizes(rnd, client)
        rng = np.random.default_rng([self.seed, 20, rnd, client])
        prompt = rng.integers(0, self.vocab, p + age).tolist()
        return RequestSpec(client, rnd, prompt, o - age)

    def first_wave(self) -> list[RequestSpec]:
        return [self.request(0, c) for c in range(self.t.clients)]
