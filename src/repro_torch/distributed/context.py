"""Mesh context + logical-axis sharding annotations (MaxText-style).

Models annotate activations with *logical* axis names; the rules below map
them to mesh axes. Outside a mesh context, and on a one-device mesh, the
annotations are no-ops, so the same model code runs on one card and on a
mesh of ranks.

The rules read only a mesh's `axis_names` and the shape of its `devices`
grid, so any object with those two attributes feeds them (a test's stand-in
as well as `Mesh`). A `PartitionSpec` holds one entry per tensor dimension:
None (replicated), a mesh-axis name, or a tuple of names (the dimension
split over those axes, the first one major). `NamedSharding` pairs a mesh
with a spec and places a tensor by it: on a one-device mesh that is a move
to the device; on a mesh of several ranks a `torch.distributed.tensor`
DTensor with one placement per mesh axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

__all__ = ["mesh_context", "current_mesh", "logical_to_spec", "shard_act",
           "AXIS_RULES", "Mesh", "NamedSharding", "PartitionSpec", "P",
           "rank_and_world", "on_mesh", "with_axis", "local_offset",
           "local_shard", "local_to_dtensor", "reduce_over",
           "gather_weights"]

_LOCAL = threading.local()

# logical axis → mesh axes (None = replicated). The "pod" axis extends data
# parallelism across pods; "fsdp_axes" is where ZeRO-3 weight shards live.
AXIS_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": ("data",),        # sequence parallelism for long-context
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "fsdp": ("pod", "data"),       # weight non-model dim for ZeRO-3 archs
    "kv_len": None,
    "kv_cache_seq": "model",       # sequence-sharded KV cache (flash-decode)
}


class PartitionSpec(tuple):
    """Per tensor dimension: None, a mesh-axis name or a tuple of names.
    Dimensions past the last entry are replicated. As in JAX, a list of
    names is a tuple, one name alone stands for itself and none for None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A grid of `torch.distributed` ranks with named axes.

    `devices` holds the ranks (any array shape, one dimension per axis);
    `device_type` is "cuda" or "cpu". Each rank computes on its current
    device. The `DeviceMesh` and the per-axis process groups are made on
    first use, once a process group is initialised."""

    def __init__(self, devices, axis_names, device_type: str = "cuda"):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.shape} grid cannot take the "
                             f"axes {self.axis_names}")
        self.device_type = device_type
        self._device_mesh = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device(self.device_type, torch.cuda.current_device())

    def device_mesh(self):
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh(
                self.device_type, torch.as_tensor(self.devices),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def group(self, axis: str):
        """The process group of the ranks along mesh axis `axis`."""
        return self.device_mesh().get_group(axis)


def rank_and_world() -> tuple[int, int]:
    """This process's rank and the world size of the initialised
    `torch.distributed` process group; (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def placements(self) -> list:
        """One DTensor placement per mesh axis: `Shard(d)` where tensor
        dimension d names the axis, else `Replicate()`."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """`t` laid out by this sharding: on the mesh's one device, or as a
        DTensor over its ranks (every rank passes the whole tensor)."""
        t = t.to(self.mesh.local_device)
        if self.mesh.size == 1:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh.device_mesh(),
                                 self.placements())


def mesh_axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes.get(name, 1)


@contextlib.contextmanager
def mesh_context(mesh: Mesh | None, rules: dict | None = None):
    """Enter a mesh (+ optional axis-rule overrides, e.g. the serving
    layout replicates 'batch' and spreads 'kv_cache_seq' over every axis)."""
    prev = getattr(_LOCAL, "mesh", None)
    prev_rules = getattr(_LOCAL, "rules", None)
    _LOCAL.mesh = mesh
    _LOCAL.rules = dict(AXIS_RULES, **(rules or {}))
    try:
        yield mesh
    finally:
        _LOCAL.mesh = prev
        _LOCAL.rules = prev_rules


def current_mesh() -> Mesh | None:
    return getattr(_LOCAL, "mesh", None)


def current_rules() -> dict:
    return getattr(_LOCAL, "rules", None) or AXIS_RULES


def _resolve(axis: str | None, mesh: Mesh) -> tuple[str, ...] | str | None:
    if axis is None:
        return None
    rule = current_rules().get(axis, None)
    if rule is None:
        return None
    names = set(mesh.axis_names)
    if isinstance(rule, str):
        return rule if rule in names else None
    picked = tuple(r for r in rule if r in names)
    return picked if picked else None


def logical_to_spec(logical: tuple[str | None, ...], mesh: Mesh) -> P:
    return P(*[_resolve(a, mesh) for a in logical])


def shard_act(x: torch.Tensor, logical: tuple[str | None, ...]):
    """Lay `x` out by logical axis names: a no-op without a mesh or on a
    one-device mesh; a DTensor is redistributed to the spec's placements,
    a dimension that its axes do not divide replicated (as the parameter
    and batch shardings do). A plain tensor on a mesh of ranks is each
    rank's own replica and stays as it is."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .shardings import _fit
    spec = _fit(logical_to_spec(logical, mesh), x.shape, mesh)
    return x.redistribute(mesh.device_mesh(),
                          NamedSharding(mesh, spec).placements())


# ---------------------------------------------------------------------------
# Local code on a mesh of ranks
#
# Where DTensor's sharding propagation has no rule for an op, or would
# gather a whole operand where XLA's partitioner keeps it sharded, the
# models run the step on each rank's shards: `with_axis` lays an operand
# out (the collective that costs is issued there), `local_shard` takes
# this rank's shard, `local_offset` says where it starts, `reduce_over`
# combines partial results across an axis, `local_to_dtensor` wraps the
# local result again and `gather_weights` gathers ZeRO-3 weights for one
# use. Every one of them is differentiable. The one-device path never
# reaches them (`on_mesh` is False there).
# ---------------------------------------------------------------------------

def on_mesh(x) -> bool:
    """Whether `x` is a DTensor inside a mesh of several ranks."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _axis_index(axis: str) -> int | None:
    names = current_mesh().axis_names
    return names.index(axis) if axis in names else None


def with_axis(t, axis: str, placement):
    """`t` redistributed so that mesh axis `axis` holds `placement`, the
    other axes as they were (unchanged when the mesh has no such axis)."""
    i = _axis_index(axis)
    if i is None or t.placements[i] == placement:
        return t
    pl = list(t.placements)
    pl[i] = placement
    return t.redistribute(t.device_mesh, pl)


def gather_weights(p: dict) -> dict:
    """A layer's weights for one use on a mesh of ranks: each split over
    the data axes (ZeRO-3) gathered whole on them, as a ZeRO-3 step
    gathers a layer's weights before it runs it (and reduce-scatters
    their gradients after); the model axis's split stays. The weights as
    they are off a mesh."""
    if not any(on_mesh(w) for w in p.values()):
        return p

    def gather(w):
        for ax in ("pod", "data"):
            w = with_axis(w, ax, Replicate())
        return w

    from torch.distributed.tensor import Replicate
    return {k: gather(w) if on_mesh(w) else w for k, w in p.items()}


def local_offset(t, dim: int) -> int:
    """Where this rank's shard of DTensor `t` starts along `dim`."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(offset[dim])


def local_shard(t) -> torch.Tensor:
    """This rank's shard of DTensor `t`, to be consumed by this rank's own
    share of the work: along every axis where `t` is replicated, the ranks'
    gradients of it are partial sums, and they are added up on the way
    back (DTensor would take each rank's for the whole gradient)."""
    from torch.distributed.tensor import Partial, Replicate
    return t.to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) else p for p in t.placements])


def local_to_dtensor(local: torch.Tensor, like, global_shape=None,
                     placements=None):
    """A DTensor over `like`'s mesh from this rank's shard `local`, laid out
    by `placements` (default `like`'s), of `global_shape` (default: the
    local shape scaled up along each sharded dimension)."""
    from torch.distributed.tensor import DTensor, Shard
    placements = list(placements or like.placements)
    if global_shape is None:
        global_shape = list(local.shape)
        for size, p in zip(like.device_mesh.shape, placements):
            if isinstance(p, Shard):
                global_shape[p.dim] *= size
    stride = [1] * len(global_shape)
    for d in range(len(global_shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * global_shape[d + 1]
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=torch.Size(global_shape),
                              stride=tuple(stride))


def _all_reduce(local: torch.Tensor, like, axes, op: str):
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = current_mesh().axis_names
    keep = [p if isinstance(p, Shard) and p.dim < local.dim()
            and a not in axes else Replicate()
            for a, p in zip(names, like.placements)]
    part = [Partial(op) if a in axes else p for a, p in zip(names, keep)]
    shape = list(local.shape)
    for size, p in zip(like.device_mesh.shape, keep):
        if isinstance(p, Shard):
            shape[p.dim] *= size
    dt = local_to_dtensor(local, like, shape, part)
    return dt.redistribute(like.device_mesh, keep).to_local()


class _Reduce(torch.autograd.Function):
    """An all-reduce whose backward passes the gradient on as it comes
    (each rank's consumer of the result computes the same thing, so its
    gradient is already the whole one), or all-reduces it too
    (`split_consumers`: each rank consumes the result with its own shard,
    so the gradients are partial)."""

    @staticmethod
    def forward(ctx, local, like, axes, op, split_consumers):
        ctx.like, ctx.axes, ctx.split = like, axes, split_consumers
        return _all_reduce(local, like, axes, op)

    @staticmethod
    def backward(ctx, grad):
        if ctx.split:
            grad = _all_reduce(grad, ctx.like, ctx.axes, "sum")
        return grad, None, None, None, None


def reduce_over(local: torch.Tensor, like, axes, op: str = "sum", *,
                split_consumers: bool = False):
    """This rank's partial `local` combined with every rank's along the
    mesh axis or axes `axes` (an all-reduce; on the other axes `local`
    keeps `like`'s placements where it has the dimension): the combined
    local tensor. Differentiable, see `_Reduce`."""
    names = current_mesh().axis_names
    axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if a in names)
    if not axes:
        return local
    return _Reduce.apply(local, like, axes, op, split_consumers)
