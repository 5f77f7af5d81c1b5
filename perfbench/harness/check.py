"""What decides `correct`: the limits a cell's numbers are held to.

The numbers themselves are the family's (`perfbench/families/<family>.py`:
`held` reads the program's state for a sample of requests live when the
window closed, `numbers` compares it, and the served tokens, with the
family's plain reference under `perfbench/reference/`). A cell's limits
are `perfbench/limits/<cell>.json`, with the readings they were set from:

  kv_mismatch   a limit per `layer<i>`: the share of layer i's stored K and
                V elements off the reference's by more than half a
                quantisation step
  kv_far        `steps`, and a limit per `layer<i>`: the share off by more
                than `steps` steps
  head_rank_median
                optional: the median over the served tokens of the
                vocabulary share the reference puts above the served token
"""
from __future__ import annotations

import dataclasses
import re


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
