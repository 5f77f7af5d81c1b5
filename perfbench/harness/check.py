"""What decides `correct`: the program's page pool and served tokens, for a
sample of requests live when the window closed, against the plain
reference (`perfbench/reference/w4a4.py`), which works the weights out
again from the drawn tensors.

The random W4A4 model is chaotic: a rounding that differs in the last bit
between the program's kernels and the reference flips an int4 code, and
the flip spreads to every row that attends to it and to every layer after
it. So the reference follows the program's cache: at each layer its
attention reads the K and V the program stored for every earlier position
(the program's state), and each layer's own K and V, which it works out
from the tokens through every layer before, are compared with the
program's. Rows still part, each as a whole, at a rate the seed sets: at
layer 1 a parted row stays within about two steps of the reference while a
row computed in a lower precision does not, so layer 1 is compared past
`steps`; deeper, parted rows read like the control (`PERF.md` section 2).
The numbers, each under a limit of `perfbench/limits/<cell>.json`:

  kv_mismatch.layer0    share of layer 0's K and V elements the program
                        stores off the reference's by more than half a
                        quantisation step
  kv_far.layer1         share of layer 1's K and V elements off by more
                        than `steps` quantisation steps
  head_rank.median      median over the served tokens of the share of the
                        vocabulary the reference's logits put above the
                        served token (the reference after every layer,
                        following the program's cache): 0 where the token
                        is the reference's greedy choice

The control is the reference in fp8 in the program's place: its own cache,
and at each position the token its fp8 logits put first.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from .weights import draw, model_dims


@dataclasses.dataclass(frozen=True)
class Limits:
    kv: tuple            # (name, layer, steps, limit)
    head_rank: float | None

    @classmethod
    def from_dict(cls, d: dict) -> "Limits":
        """Keys `layer<i>` of `kv_mismatch` (off by more than half a step)
        and of `kv_far` (by more than its `steps`), and an optional
        `head_rank_median`."""
        kv = []
        for group, steps in (("kv_mismatch", 0.5), ("kv_far", None)):
            entries = dict(d.get(group, {}))
            if steps is None and entries:
                steps = float(entries.pop("steps"))
            for key, lim in entries.items():
                m = re.fullmatch(r"layer(\d+)", key)
                if m is None:
                    raise ValueError(f"bad {group} key {key!r}")
                kv.append((f"{group}.{key}", int(m[1]), steps, float(lim)))
        return cls(kv=tuple(kv),
                   head_rank=None if "head_rank_median" not in d
                   else float(d["head_rank_median"]))

    def layers_held(self, n_layers: int) -> int:
        """The layers of the pool the check reads: every layer where the
        head is compared, else those up to the last compared."""
        if self.head_rank is not None:
            return n_layers
        return min(max(e[1] for e in self.kv) + 1, n_layers)

    def limit_of(self) -> dict:
        out = {e[0]: e[3] for e in self.kv}
        if self.head_rank is not None:
            out["head_rank.median"] = self.head_rank
        return out


class _Tally:
    """Elements of each layer's K and V off the reference's by more than
    a number of quantisation steps, and elements."""

    def __init__(self):
        self.n: dict = {}

    def add(self, l: int, steps: float, got: tuple, want: tuple):
        k, v, ks, vs = want
        c = self.n.setdefault((l, steps), [0, 0])
        for g, r, sc in ((got[0], k, ks), (got[1], v, vs)):
            c[0] += int(((g - r).abs() > steps * sc).sum())
            c[1] += g.numel()

    def share(self, l: int, steps: float) -> float:
        bad, n = self.n.get((l, steps), (0, 0))
        return bad / n if n else float("inf")


def _served_ranks(ref, spec, x, picked, first: int) -> torch.Tensor:
    """Share of the vocabulary the reference's logits put above each token
    picked after positions first .. S-2 (`picked[p]` follows position p),
    from final hidden states x [S, d]."""
    from perfbench.reference import w4a4
    out = []
    for lo in range(first, x.shape[0] - 1, 512):
        hi = min(lo + 512, x.shape[0] - 1)
        lg = w4a4.logits(ref, spec, x[lo:hi])
        got = lg.gather(1, picked[lo:hi, None])
        out.append((lg > got).sum(dim=-1) / lg.shape[-1])
    return torch.cat(out) if out else torch.empty(0, device=x.device)


@torch.no_grad()
def numbers(cfg: dict, seed: int, device, held: list[dict], lim: Limits,
            control: bool = False) -> dict:
    """Every number of the check over the held requests; with `control`,
    of the fp8 reference in the program's place instead."""
    from perfbench.reference import w4a4
    spec = model_dims(cfg)
    n_held = len(held[0]["layers"])
    params = draw(cfg, seed, device)
    ref = w4a4.prepare(params, spec, n_held)
    del params
    has_head = "head" in ref
    tally = _Tally()
    compared = [(name, min(l, n_held - 1), steps)
                for name, l, steps, _ in lim.kv]
    ranks = []
    for h in held:
        toks = torch.tensor(h["tokens"], dtype=torch.int64, device=device)
        first = max(h["prompt_len"] - 1, 0)
        if control:
            own = list(w4a4.forward(ref, spec, toks, fmt="fp8"))
            x_own = own.pop() if has_head else None
            kv = [o[:2] for o in own]
            picked = None if lim.head_rank is None else \
                w4a4.logits(ref, spec, x_own, fmt="fp8").argmax(-1)
            del own, x_own
        else:
            kv = h["layers"]
            picked = toks[1:]
        out = list(w4a4.forward(ref, spec, toks, follow=kv))
        x = out.pop() if has_head else None
        for _, l, steps in compared:
            tally.add(l, steps, kv[l], out[l])
        if lim.head_rank is not None and first < len(h["tokens"]) - 1:
            ranks.append(_served_ranks(ref, spec, x, picked, first))
        del out, x, kv
    res = {name: tally.share(l, steps) for name, l, steps in compared}
    res["positions"] = sum(len(h["tokens"]) for h in held)
    if lim.head_rank is not None:
        r = torch.cat(ranks) if ranks else torch.empty(0)
        res["head_rank.median"] = float(r.median()) if r.numel() \
            else float("inf")
        res["served_tokens"] = int(r.numel())
    return res
