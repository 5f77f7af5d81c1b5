"""Carrying the JAX package's trees into the port, as numpy arrays.

`jax.random` and `torch.Generator` cannot agree on numbers, so parity tests
build parameters with the JAX package, turn every leaf into a numpy array
(`jax.tree.map(np.asarray, tree)`) and hand the tree to these functions.
This module takes numpy only and imports nothing of JAX. bfloat16 leaves
(numpy arrays of the `bfloat16` extension dtype) cross through a 16-bit
integer view, bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .kernels.int4_matmul import int4_colsum

Params = dict[str, Any]


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One leaf -> a torch tensor on `device`, dtype preserved (bfloat16
    through an int16 view)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def tree_from_numpy(tree, device="cuda"):
    """A (nested dict) tree of numpy leaves -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def _add_colsum(node: Params):
    """Give every packed projection (a dict holding "packed" and "scale")
    its int32 column sums, layer by layer for stacked leaves."""
    if not isinstance(node, dict):
        return
    if "packed" in node and "scale" in node:
        packed = node["packed"]
        if "colsum" not in node:
            node["colsum"] = (
                torch.stack([int4_colsum(p) for p in packed])
                if packed.dim() == 3 else int4_colsum(packed))
        return
    for v in node.values():
        _add_colsum(v)


def params_from_jax(numpy_tree: Params, device="cuda") -> Params:
    """The JAX package's packed parameter tree (what its
    `pack_dense_params` returns: scan-stacked `[n_layers, ...]` leaves,
    uint8 `packed`, f32 `scale`, float leaves in the parameter dtype), as
    numpy arrays -> the port's packed parameters on `device`, with the
    `colsum` leaf the port stores at pack time added to every projection."""
    params = tree_from_numpy(numpy_tree, device)
    _add_colsum(params)
    return params


def cache_from_jax(numpy_cache: Params, device="cuda") -> Params:
    """A dense KV cache of the JAX package's `QuantizedDenseLM.init_cache`
    layout (`[n_layers, batch, max_len, ...]` leaves) -> tensors on
    `device`. The port updates the result in place."""
    return tree_from_numpy(numpy_cache, device)


def opt_state_from_jax(numpy_state: Params, device="cuda") -> Params:
    """The JAX package's AdamW state (`{"step", "m", "v"}`, as numpy
    arrays) -> the port's: the int32 step count and the moment trees as
    tensors on `device`, dtypes preserved."""
    return {"step": tensor_from_numpy(
                np.asarray(numpy_state["step"], np.int32), device),
            "m": tree_from_numpy(numpy_state["m"], device),
            "v": tree_from_numpy(numpy_state["v"], device)}
