"""Paged continuous-batching serving engine.

One `ServableModel` adapter (`adapter`), a paged KV state with refcounted
pages, per-sequence block tables and a host swap tier (`pages`), a radix
prefix cache over the pages (`radix`), a seedable fault plan (`faults`) and
a chunked-prefill continuous-batching scheduler (`scheduler`) with
optimistic admission backed by preemption and replay, request lifecycles
(cancel, deadlines, drain, token streaming) and the swap-vs-replay cost
rule. The kv data path is block-table-native: the pool and block tables
flow into the model's `forward_chunk`, which writes new KV rows into their
pages and attends by walking the table in `kernels.ops.paged_attention`.
"""
from .adapter import (DenseModelAdapter, IntegerModelAdapter, ServableModel,
                      StateSpec, as_servable, derive_state_spec)
from .faults import DispatchFault, FaultPlan, SwapFault
from .pages import (SCRATCH_PAGE, HostPageRef, HostSwapPool, PageAllocator,
                    PagedKVCache, pages_for)
from .radix import RadixCache, RadixNode
from .scheduler import (EngineRequest, EngineStalledError, SamplingParams,
                        ServeEngine)

__all__ = [
    "ServableModel", "StateSpec", "derive_state_spec", "DenseModelAdapter",
    "IntegerModelAdapter",
    "as_servable", "PageAllocator", "PagedKVCache", "pages_for",
    "SCRATCH_PAGE", "EngineRequest", "EngineStalledError", "SamplingParams",
    "ServeEngine", "FaultPlan", "DispatchFault", "SwapFault", "RadixCache",
    "RadixNode", "HostPageRef", "HostSwapPool",
]
