"""Serving steps: prefill + decode with greedy or temperature sampling, and
the legacy dense-slot continuous-batching scheduler (`BatchScheduler`,
the launcher's `--legacy-scheduler`; the paged `engine.ServeEngine` is the
main path).

Sampling draws from an explicit `torch.Generator`; greedy tokens are the
first argmax, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Params = Any


def make_prefill_step(model) -> Callable:
    def prefill_step(params: Params, batch: Params, cache: Params):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(model, *, temperature: float = 0.0) -> Callable:
    def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                    index, gen: torch.Generator | None = None):
        logits, cache = model.decode_step(params, tokens, cache, index)
        if temperature > 0 and gen is not None:
            probs = torch.softmax(logits.to(torch.float32) / temperature,
                                  dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None].to(torch.int64), logits, cache

    return decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


class BatchScheduler:
    """Continuous batching with fixed slots (per-token admission).

    Every active slot advances one token per `step()`: a slot still in its
    prompt feeds the next prompt token, a generating slot its last sampled
    token. Per-slot cache indices keep each sequence's KV writes apart, so
    a request is admitted mid-flight without disturbing the others. A freed
    slot's KV range is zeroed on reuse. Attention-cache models only.
    """

    def __init__(self, model, params, *, slots: int, max_len: int,
                 temperature: float = 0.0, cache_dtype=torch.float32,
                 seed: int = 0):
        if model.cfg.family in ("ssm", "hybrid"):
            raise ValueError("per-slot scheduler requires attention caches")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}
        self.prompt_ptr: dict[int, int] = {}
        self.pos = [0] * slots
        self.next_feed = [0] * slots
        self.device = params["lm_head"].device
        self.cache = model.init_cache(slots, max_len, dtype=cache_dtype,
                                      device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._decode = make_decode_step(model, temperature=temperature)

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.pop(0)
            if self.pos[slot] > 0:
                # slot reuse: zero the previous occupant's KV range rather
                # than rely on the per-slot causal mask alone
                for leaf in self.cache.values():
                    leaf[:, slot] = 0
            self.active[slot] = req
            self.prompt_ptr[slot] = 0
            self.pos[slot] = 0
            self.next_feed[slot] = req.prompt[0]

    def step(self) -> list[Request]:
        """Advance every active slot one token; returns finished
        requests."""
        self._admit()
        if not self.active:
            return []
        dev = self.device
        tokens = torch.tensor([[self.next_feed[s]] for s in range(self.slots)],
                              dtype=torch.int64, device=dev)
        idx = torch.tensor(self.pos, dtype=torch.int32, device=dev)
        gen = self._gen if self.temperature > 0 else None
        nxt, _, self.cache = self._decode(self.params, tokens, self.cache,
                                          idx, gen)
        nxt = nxt[:, 0].tolist()
        finished = []
        for slot, req in list(self.active.items()):
            self.pos[slot] += 1
            ptr = self.prompt_ptr[slot]
            if ptr + 1 < len(req.prompt):
                # still in the prompt: feed its next token
                self.prompt_ptr[slot] = ptr + 1
                self.next_feed[slot] = req.prompt[ptr + 1]
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.next_feed[slot] = tok
            if req.done or self.pos[slot] >= self.max_len - 1:
                finished.append(req)
                del self.active[slot]
                self.prompt_ptr.pop(slot, None)
        return finished

    def run(self) -> list[Request]:
        done = []
        while self.queue or self.active:
            done.extend(self.step())
        return done
