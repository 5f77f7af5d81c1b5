"""Paged continuous-batching serving engine.

One `ServableModel` adapter (`adapter`), a paged KV state with refcounted
pages and per-sequence block tables (`pages`), and a chunked-prefill
continuous-batching scheduler (`scheduler`). The kv data path is
block-table-native: the pool and block tables flow into the model's
`forward_chunk`, which writes new KV rows into their pages and attends by
walking the table in `kernels.ops.paged_attention`.
"""
from .adapter import (IntegerModelAdapter, ServableModel, StateSpec,
                      as_servable, derive_state_spec)
from .pages import SCRATCH_PAGE, PageAllocator, PagedKVCache, pages_for
from .scheduler import EngineRequest, SamplingParams, ServeEngine

__all__ = [
    "ServableModel", "StateSpec", "derive_state_spec", "IntegerModelAdapter",
    "as_servable", "PageAllocator", "PagedKVCache", "pages_for",
    "SCRATCH_PAGE", "EngineRequest", "SamplingParams", "ServeEngine",
]
