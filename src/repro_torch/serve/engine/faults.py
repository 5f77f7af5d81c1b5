"""Deterministic fault injection for the paged serving engine.

A `FaultPlan` is a seedable schedule of adversities the scheduler asks
about at well-defined points of each `step()`:

  * **allocator exhaustion** — `take_exhaustion(step)` makes the next
    page-growth attempt of that step raise `MemoryError` exactly as a
    genuinely empty free list would, driving the scheduler's preemption
    path without needing a pathological trace to fill the pool;
  * **dispatch faults** — `take_dispatch_fault(step)` injects a
    transient failure (`"fail"`: the fused device dispatch for that
    step's phase raises `DispatchFault` *before* launching, so engine
    state is untouched and the step simply makes no forward progress) or
    a delay (`"delay"`: the scheduler sleeps `dispatch_delay_s` before
    dispatching — wall-time histograms stretch, nothing else moves);
  * **lifecycle chaos** — `cancels_due(step, live)` / `expiries_due(
    step, live)` name requests the scheduler must cancel or force-expire
    at the top of that step, combining explicit `{step: (rid, ...)}`
    schedules with seeded random picks from the live set;
  * **swap I/O faults** — `take_swap_fault(step)` fails the step's
    first host<->device page transfer with `SwapFault` *before* any
    pool or ledger mutation, driving the scheduler's retry-with-backoff
    and fall-back-to-recompute degradation paths.

Determinism contract: every random decision is drawn from
`numpy.random.default_rng((seed, salt, step))` — a pure function of the
plan's seed and the step index, never of call order — so a chaos test
that replays the same plan against the same trace sees the same faults.
Injected exhaustions and dispatch faults fire at most once per step
(tracked in `_fired`): after the scheduler preempts a victim and
retries, the retry behaves like a real post-preemption allocator.

The injection points only ever (a) raise the same exceptions the real
system can raise, before any state mutation, or (b) call the engine's
public `cancel` / expiry paths — a plan can therefore never corrupt
state itself, which is what lets the chaos tests assert the engine's
invariants (no page/slot leaks, balanced books, bit-identical
survivors) under arbitrary plans.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class DispatchFault(RuntimeError):
    """Injected transient failure of a fused device dispatch (raised
    before the dispatch launches, so no engine state was touched)."""


class SwapFault(RuntimeError):
    """Injected failure of a host<->device page-swap transfer (raised
    before any pool or ledger mutation, so the scheduler can retry the
    swap with backoff or fall back to recompute-by-replay)."""


@dataclasses.dataclass
class FaultPlan:
    """Seedable, deterministic fault schedule for one engine run.

    Explicit schedules (`*_steps`, `*_at`) compose with random rates
    (`*_rate`, probability per engine step). Steps are the engine's
    internal step index, starting at 0 and never reset by
    `reset_metrics()`.
    """
    seed: int = 0
    # allocator exhaustion: force the step's first page-growth attempt
    # to raise MemoryError
    exhaust_steps: tuple[int, ...] = ()
    exhaust_rate: float = 0.0
    # dispatch faults: fail (no progress) or delay the fused dispatch
    dispatch_fail_steps: tuple[int, ...] = ()
    dispatch_fail_rate: float = 0.0
    dispatch_delay_steps: tuple[int, ...] = ()
    dispatch_delay_s: float = 0.0
    # lifecycle chaos: cancel / force-expire requests at step boundaries
    cancel_at: dict[int, tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    cancel_rate: float = 0.0
    expire_at: dict[int, tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    expire_rate: float = 0.0
    # swap I/O faults: fail the step's first host<->device page transfer
    swap_fail_steps: tuple[int, ...] = ()
    swap_fail_rate: float = 0.0

    def __post_init__(self):
        for name in ("exhaust_rate", "dispatch_fail_rate", "cancel_rate",
                     "expire_rate", "swap_fail_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.dispatch_delay_s < 0:
            raise ValueError(f"dispatch_delay_s must be >= 0, "
                             f"got {self.dispatch_delay_s}")
        for name in ("exhaust_steps", "dispatch_fail_steps",
                     "dispatch_delay_steps", "swap_fail_steps"):
            bad = [s for s in getattr(self, name) if s < 0]
            if bad:
                raise ValueError(
                    f"{name} has negative step index(es) {bad}")
        for name in ("cancel_at", "expire_at"):
            bad = [s for s in getattr(self, name) if s < 0]
            if bad:
                raise ValueError(
                    f"{name} has negative step index(es) {bad}")
        # at-most-once-per-step latches for the raising injections
        self._fired: set[tuple[str, int]] = set()

    # -- deterministic randomness ---------------------------------------

    def _rng(self, salt: int, step: int) -> np.random.Generator:
        """Pure function of (seed, salt, step) — call order never shifts
        the stream, so identical plans replay identical faults."""
        return np.random.default_rng((self.seed, salt, step))

    def _once(self, kind: str, step: int) -> bool:
        if (kind, step) in self._fired:
            return False
        self._fired.add((kind, step))
        return True

    # -- queries the scheduler makes ------------------------------------

    def take_exhaustion(self, step: int) -> bool:
        """True exactly once for a step whose growth should fail."""
        due = step in self.exhaust_steps or (
            self.exhaust_rate > 0
            and self._rng(1, step).random() < self.exhaust_rate)
        return due and self._once("exhaust", step)

    def take_dispatch_fault(self, step: int) -> str | None:
        """"fail", "delay", or None — at most one injection per step
        (an explicit fail schedule wins over an explicit delay)."""
        if step in self.dispatch_fail_steps or (
                self.dispatch_fail_rate > 0
                and self._rng(2, step).random() < self.dispatch_fail_rate):
            return "fail" if self._once("dispatch", step) else None
        if step in self.dispatch_delay_steps:
            return "delay" if self._once("dispatch", step) else None
        return None

    def take_swap_fault(self, step: int) -> bool:
        """True exactly once for a step whose first swap transfer should
        fail. The latch is shared across directions: whichever of
        swap-out / swap-in the scheduler attempts first that step takes
        the `SwapFault`; retries within the same step see a healthy
        tier, mirroring a transient host-I/O hiccup."""
        due = step in self.swap_fail_steps or (
            self.swap_fail_rate > 0
            and self._rng(5, step).random() < self.swap_fail_rate)
        return due and self._once("swap", step)

    def _lifecycle(self, step: int, live: list[int], at: dict, rate: float,
                   salt: int) -> list[int]:
        due = [rid for rid in at.get(step, ()) if rid in live]
        if rate > 0 and live:
            rng = self._rng(salt, step)
            if rng.random() < rate:
                pick = int(live[int(rng.integers(len(live)))])
                if pick not in due:
                    due.append(pick)
        return due

    def cancels_due(self, step: int, live: list[int]) -> list[int]:
        """Request ids (⊆ `live`) the scheduler must cancel this step."""
        return self._lifecycle(step, live, self.cancel_at,
                               self.cancel_rate, 3)

    def expiries_due(self, step: int, live: list[int]) -> list[int]:
        """Request ids (⊆ `live`) to force-expire this step, regardless
        of their wall-clock deadline (deterministic TTL testing)."""
        return self._lifecycle(step, live, self.expire_at,
                               self.expire_rate, 4)
