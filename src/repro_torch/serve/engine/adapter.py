"""Model adapter: the `ServableModel` protocol the paged engine schedules.

Each adapter derives a `StateSpec` from its config declaring which state
kinds the model carries: `kv` (sequence-length-proportional attention
caches, stored in page pools and addressed through block tables) and
`register` (fixed-size per-sequence state of SSM layers; not ported yet).
`init_state(n_pages, page_size, n_slots)` builds the `{"kv": ...,
"register": {}}` tree the engine owns, and `forward_chunk` runs one [B, S]
chunk against it: kv rows are scattered straight into their pages and
attention walks the table through `kernels.ops.paged_attention`.

Two execution paths are servable: the bf16 or fake-quant `Model` (the
fake-quant model is the same class with the PTQ hooks installed; float KV
pages, f32 by default as in the reference) and the packed-int4
`QuantizedDenseLM`. Register-slot state (SSM, hybrid) is ROADMAP Queue A10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch

from ...models.transformer import Model
from ..quantized import QuantizedDenseLM

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """Which paged-state kinds a served model's cache carries.

    `kv`: grows with sequence length; block-table-indexed page pools.
    `register`: fixed size per sequence; slot-indexed register pools.
    """
    kv: bool
    register: bool
    register_leaves: tuple[str, ...] = ()

    @property
    def prefix_shareable(self) -> bool:
        """kv pages are position-addressable, so a cached prefix page is
        valid for any sequence with the same leading tokens; register state
        is a running summary and never shareable."""
        return self.kv and not self.register


def derive_state_spec(cfg) -> StateSpec:
    """Per-family state spec - the capability check for servability.

    Raises ValueError for configs the paged engine cannot serve at all:
    encoder-only families (no autoregressive decode step) and frontend
    models (the engine schedules token streams).
    """
    if cfg.family == "encoder":
        raise ValueError(
            f"{cfg.name}: encoder-only family has no autoregressive decode "
            "step - there is nothing for the serving engine to schedule")
    if cfg.frontend is not None:
        raise ValueError(
            f"{cfg.name}: paged serving engine serves token LMs only "
            f"(frontend={cfg.frontend!r} supplies non-token inputs)")
    if cfg.family in ("dense", "vlm", "moe"):
        return StateSpec(kv=True, register=False)
    if cfg.family == "ssm":
        return StateSpec(kv=False, register=True,
                         register_leaves=("conv", "state"))
    if cfg.family == "hybrid":
        return StateSpec(kv=True, register=True,
                         register_leaves=("conv", "state"))
    raise ValueError(f"{cfg.name}: family {cfg.family!r} has no state spec")


@runtime_checkable
class ServableModel(Protocol):
    """What the paged engine needs from an execution path."""

    cfg: Any
    params: Params

    @property
    def state_spec(self) -> StateSpec:
        ...

    def init_state(self, n_pages: int, page_size: int,
                   n_slots: int) -> Params:
        """`{"kv": ..., "register": ...}` paged state: kv leaves
        [n_layers, n_pages, page_size, ...]."""
        ...

    def init_cache(self, batch: int, max_len: int) -> Params:
        """The model's native dense contiguous cache (test oracle)."""
        ...

    def forward_chunk(self, params: Params, tokens: torch.Tensor,
                      cache: Params, index,
                      block_table: torch.Tensor | None = None,
                      seq_lengths: torch.Tensor | None = None,
                      register_index: torch.Tensor | None = None):
        """[B, S] tokens at fill position(s) `index` -> ([B, S, V] logits,
        the cache, updated in place). In paged mode (`block_table` [B, P]
        present) `cache` is the engine's state tree; `seq_lengths` [B]
        (true context lengths, 0 for padded rows) drive the paged kernel's
        ragged early exit."""
        ...


class _AdapterBase:
    name: str
    # quality probes (serve.telemetry.quality) are instrumented on the
    # integer path; adapters that cannot run them advertise it so the
    # engine rejects a probed configuration at construction, not mid-run
    supports_quality_probes: bool = False

    def __init__(self, cfg, params: Params):
        # capability check: raises for encoder/frontend configs
        self.spec = derive_state_spec(cfg)
        self.cfg = cfg
        self.params = params

    @property
    def state_spec(self) -> StateSpec:
        return self.spec

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device


class DenseModelAdapter(_AdapterBase):
    """bf16 or fake-quant `Model` (the PTQ hooks ride along). Its state is
    pure kv for the families the port serves, on the parameters'
    device."""

    def __init__(self, model: Model, params: Params, *, name: str = "bf16",
                 cache_dtype=torch.float32):
        super().__init__(model.cfg, params)
        self.model = model
        self.name = name
        self.cache_dtype = cache_dtype

    def init_state(self, n_pages: int, page_size: int,
                   n_slots: int = 0) -> Params:
        return self.model.init_paged_state(n_pages, page_size, n_slots,
                                           dtype=self.cache_dtype,
                                           device=self.device)

    def init_cache(self, batch: int, max_len: int) -> Params:
        return self.model.init_cache(batch, max_len, dtype=self.cache_dtype,
                                     device=self.device)

    def forward_chunk(self, params, tokens, cache, index, block_table=None,
                      seq_lengths=None, register_index=None, *,
                      probe=False):
        if probe:
            raise ValueError("quality probes are instrumented on the "
                             "integer path only (QuantizedDenseLM)")
        if register_index is not None:
            raise ValueError("register-slot state is ROADMAP Queue A10")
        paged = block_table is not None
        caches = cache["kv"] if paged else cache
        logits, _ = self.model.forward_chunk(params, tokens, caches, index,
                                             block_table, seq_lengths)
        return logits, cache


class IntegerModelAdapter(_AdapterBase):
    """Packed-int4 `QuantizedDenseLM` (params = packed weights). Dense archs
    only, so its state is pure kv. The state lives on the parameters'
    device."""

    supports_quality_probes = True

    def __init__(self, qlm: QuantizedDenseLM, packed_params: Params):
        super().__init__(qlm.cfg, packed_params)
        self.qlm = qlm
        self.name = f"int4_kv{qlm.kv_bits or 'bf16'}"

    # float KV pages are bf16 whatever the compute dtype, as in the
    # reference adapter (`init_cache`'s default)
    cache_dtype = torch.bfloat16

    def init_state(self, n_pages: int, page_size: int,
                   n_slots: int = 0) -> Params:
        return {"kv": self.qlm.init_cache(n_pages, page_size,
                                          dtype=self.cache_dtype,
                                          device=self.device),
                "register": {}}

    def init_cache(self, batch: int, max_len: int) -> Params:
        return self.qlm.init_cache(batch, max_len, dtype=self.cache_dtype,
                                   device=self.device)

    def forward_chunk(self, params, tokens, cache, index, block_table=None,
                      seq_lengths=None, register_index=None, *,
                      probe=False):
        if register_index is not None:
            raise ValueError("integer path serves kv-only state")
        paged = block_table is not None
        caches = cache["kv"] if paged else cache
        out = self.qlm.forward_chunk(params, tokens, caches, index,
                                     block_table, seq_lengths, probe=probe)
        # the caches were updated in place: hand the engine's tree back, and
        # with probe=True the per-layer stats after it
        return (out[0], cache, *out[2:])


def as_servable(model, params: Params, **kw) -> ServableModel:
    """Wrap a supported execution path in its engine adapter."""
    if isinstance(model, QuantizedDenseLM):
        return IntegerModelAdapter(model, params)
    if isinstance(model, Model):
        return DenseModelAdapter(model, params, **kw)
    raise TypeError(f"{type(model).__name__} is not a servable model "
                    "(Model or QuantizedDenseLM)")
