"""Parameter / batch / cache / optimizer-state sharding inference.

Specs are derived from leaf *names* in the model param tree (the tree layout
is owned by `repro_torch.models.transformer`, so the rules here are the
single source of truth for how every tensor class is laid out on the mesh).
They are pure functions of the leaf paths and shapes, so a tree of meta
tensors (`Model.init_shapes`) gives every leaf's spec without allocating
it.

ZeRO-3 ("fsdp") sharding of the non-model weight dim over ('pod','data') is
switched on per-arch for the ≥33B models.
"""
from __future__ import annotations

from typing import Any

from ..tree import flatten_with_paths, tree_map, unflatten
from .context import Mesh, NamedSharding, PartitionSpec as P

Params = Any

# archs whose weights must be ZeRO-3 sharded to fit one device's memory
ZERO3_ARCHS = {"deepseek-coder-33b", "llama4-maverick-400b-a17b"}


def _axes(mesh: Mesh, *names):
    """Keep only axes present in this mesh; () → None."""
    out = tuple(n for n in names if n in mesh.axis_names)
    if not out:
        return None
    return out if len(out) > 1 else out[0]


def _dp(mesh):
    return _axes(mesh, "pod", "data")


def _fit(spec: P, shape, mesh: Mesh) -> P:
    """Every sharded dim must divide evenly; replace non-dividing entries
    with replication."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        for a in axes:
            total *= sizes[a]
        out.append(entry if dim % total == 0 else None)
    return P(*out)


def param_spec(path: str, ndim: int, mesh: Mesh, *, zero3: bool) -> P:
    """PartitionSpec for a parameter leaf. `path` is '/'-joined tree keys
    (a leading 'layers/' or 'shared_attn/' prefix may be present; stacked
    leaves have a leading L dim which is never sharded)."""
    name = path.split("/")[-1]
    stacked = path.startswith("layers/")
    lead = (None,) if stacked else ()
    mdl = _axes(mesh, "model")
    fsdp = _dp(mesh) if zero3 else None

    def spec(*dims):
        return P(*lead, *dims)

    if name in ("embed",):
        return P(mdl, fsdp)                     # [V, d] vocab-sharded
    if name in ("lm_head",):
        return P(fsdp, mdl)                     # [d, V]
    if name in ("frontend_proj",):
        return P(None, fsdp)
    if name in ("wq", "wk", "wv"):
        return spec(fsdp, mdl)                  # [d, h·dh] column-parallel
    if name == "wo":
        return spec(mdl, fsdp)                  # [h·dh, d] row-parallel
    if name in ("bq", "bk", "bv"):
        return spec(mdl)
    if name in ("w_gate", "w_up", "shared_gate", "shared_up"):
        if ndim - len(lead) == 3:               # MoE expert weights [E, d, f]
            return spec(mdl, fsdp, None)
        return spec(fsdp, mdl)
    if name in ("w_down", "shared_down"):
        if ndim - len(lead) == 3:               # [E, f, d]
            return spec(mdl, None, fsdp)
        return spec(mdl, fsdp)
    if name == "router":
        return spec(fsdp, mdl)                  # [d, E]
    if name == "in_proj":
        return spec(fsdp, mdl)                  # [d, 2di+2N+H]
    if name == "out_proj":
        return spec(mdl, fsdp)                  # [d_inner, d]
    if name in ("conv_w", "conv_b"):
        return spec(*([None] * (ndim - len(lead) - 1)), mdl)
    if name in ("A_log", "D", "dt_bias", "norm_scale"):
        return spec(mdl) if ndim - len(lead) == 1 else spec(None, mdl)
    if name in ("scale", "bias"):
        return spec(*([None] * (ndim - len(lead))))
    # fallback: replicate
    return P(*([None] * ndim))


def _path_str(path: tuple) -> str:
    """A leaf path as the reference writes it: dict keys as they are,
    sequence indices in brackets, joined by '/'."""
    return "/".join(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


def _tree_paths(tree: Params):
    flat = flatten_with_paths(tree)
    return [_path_str(p) for p, _ in flat], [leaf for _, leaf in flat]


def param_shardings(mesh: Mesh, params: Params, arch: str) -> Params:
    zero3 = arch in ZERO3_ARCHS
    paths, leaves = _tree_paths(params)
    specs = [_fit(param_spec(p, len(l.shape), mesh, zero3=zero3),
                  l.shape, mesh)
             for p, l in zip(paths, leaves)]
    return unflatten(params, [NamedSharding(mesh, s) for s in specs])


def batch_shardings(mesh: Mesh, batch: Params) -> Params:
    dp = _dp(mesh)

    def spec(leaf):
        nd = len(leaf.shape)
        return NamedSharding(mesh, _fit(P(dp, *([None] * (nd - 1))),
                                        leaf.shape, mesh))

    return tree_map(spec, batch)


SERVE_RULES = {
    # serving layout for ZeRO-3 archs: weights stay 2D-sharded (d_in over
    # ('pod','data'), d_out over 'model') and activations flow as psum'd
    # partials; batch is replicated so the data axes are free for weight
    # contraction dims; the KV cache spreads its sequence over every axis.
    "batch": None,
    "kv_cache_seq": ("pod", "data", "model"),
}


def serve_cache_shardings(mesh: Mesh, cache: Params) -> Params:
    """KV cache for the replicated-batch serving layout: sequence sharded
    over all mesh axes; SSM state/conv sharded on channels over 'model'."""
    all_axes = _axes(mesh, "pod", "data", "model")
    mdl = _axes(mesh, "model")

    def spec_for(path, shape):
        name = path.split("/")[-1]
        if name in ("k", "v"):
            return P(None, None, all_axes, None, None)
        if name == "conv":
            return P(None, None, None, mdl)
        if name == "state":
            return P(None, None, mdl, None, None)
        return P(*([None] * len(shape)))

    paths, leaves = _tree_paths(cache)
    return unflatten(cache, [
        NamedSharding(mesh, _fit(spec_for(p, l.shape), l.shape, mesh))
        for p, l in zip(paths, leaves)])


def cache_spec(path: str, shape, mesh: Mesh) -> P:
    """KV/SSM cache leaves (stacked [L, ...] or [G, ...] first dim).

    KV caches shard heads on 'model' when the head count divides the axis;
    otherwise they shard the *sequence* dim instead (flash-decoding style —
    replicating a 32k cache over 16 model shards would be a 16× memory
    blowup, which is exactly what the GQA kv=8 archs hit on a 16-way TP
    mesh).
    """
    dp = _dp(mesh)
    mdl = _axes(mesh, "model")
    name = path.split("/")[-1]
    msize = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
    if name in ("k", "v"):      # [L, B, S, KH, Dh]
        kh, s = shape[3], shape[2]
        if mdl is not None and kh % msize == 0:
            return P(None, dp, None, mdl, None)
        if mdl is not None and s % msize == 0:
            return P(None, dp, mdl, None, None)   # sequence-sharded cache
        return P(None, dp, None, None, None)
    if name == "conv":          # [L, B, W, C]
        return P(None, dp, None, mdl)
    if name == "state":         # [L, B, H, N, P]
        return P(None, dp, mdl, None, None)
    return P(*([None] * len(shape)))


def cache_shardings(mesh: Mesh, cache: Params) -> Params:
    paths, leaves = _tree_paths(cache)
    return unflatten(cache, [
        NamedSharding(mesh, _fit(cache_spec(p, l.shape, mesh), l.shape,
                                 mesh))
        for p, l in zip(paths, leaves)])


def opt_state_shardings(mesh: Mesh, opt_state: Params, params: Params,
                        arch: str) -> Params:
    pshard = param_shardings(mesh, params, arch)
    return {
        "step": NamedSharding(mesh, P()),
        "m": pshard,
        "v": pshard,
    }


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
