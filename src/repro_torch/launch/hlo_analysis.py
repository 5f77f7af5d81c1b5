"""Per-device cost of one step, counted from the aten ops it dispatches.

The reference (`repro/launch/hlo_analysis.py::analyze_hlo`) walks the
optimized, SPMD-partitioned HLO text of a compiled step. The port has no
HLO and no compiler: `analyze_step(fn, *args, **kw)` runs the step once
under a `TorchDispatchMode`, on meta tensors (or DTensors over meta shards
on a mesh of ranks), so nothing is allocated and nothing is computed, and
counts every aten op that reaches the device:

  * FLOPs of matmuls, convolutions and their batched forms, by
    `torch.utils.flop_counter`'s formulas (2·|out|·K for a product, as the
    reference's dot rule);
  * HBM traffic of every materialising op: its tensor operands plus its
    output. Views, reshapes, `detach` and other aliasing ops are free (the
    reference's `_FREE_OPS`); a copy into a slice or an index (`copy_`,
    `index_put_`, ...) is charged twice the update, as the reference
    charges an in-place `dynamic-update-slice`; a gather of rows (`index`,
    `embedding`, ...) the rows it reads, not its whole source (the
    reference charges a gather its whole operand: an embedding table per
    decode step);
  * the peak of the live bytes the step allocates (each output's storage,
    held through a weak reference until it dies): the counterpart of
    `memory_analysis().temp_size_in_bytes`;
  * collective payload bytes and counts per kind for every
    `_c10d_functional` / `c10d_functional` collective that DTensor's
    sharding propagation inserts, under the reference's kind names and its
    convention: the bytes of the collective's result on one device, no ring
    factor.

A DTensor op is not counted itself: the mode lets DTensor run it and counts
the ops DTensor issues on the local shards, so every number is **per
device**, as the reference's are. A Python loop runs every trip, so there
are no trip counts to correct.

A hand-written kernel's wrapper (`kernels/ops.py`) called on meta tensors
counts as one op (`kernel_op`): the FLOPs of its plain version's products
and the bytes the kernel moves, its operands and outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["HloCosts", "analyze_step", "kernel_op", "tensor_bytes"]

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")

# ops that move no bytes: they alias, or allocate without writing
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "_unsafe_view",
         "wait_tensor", "_local_scalar_dense", "resize_", "set_"}
# reads of rows picked from their first operand: charged the rows (the
# output's bytes), the indices and the output, not the whole source
_GATHERS = {"index", "index_select", "embedding", "gather"}
# writes into a slice or at indices of their first operand, which they do
# not read: charged twice the update
_SCATTER_WRITES = {"copy_", "index_put_", "_index_put_impl_", "index_copy_",
                   "scatter_", "slice_scatter", "select_scatter"}


def tensor_bytes(t) -> int:
    """Bytes of a tensor, or of every tensor in a (nested) list/tuple."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(tensor_bytes(x) for x in t)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _shape_str(t: torch.Tensor) -> str:
    dt = str(t.dtype).replace("torch.", "")
    return f"{dt}[{','.join(str(d) for d in t.shape)}]"


@dataclasses.dataclass
class HloCosts:
    """The reference's fields (`flops`, `bytes_accessed`,
    `collective_bytes`, `collective_counts`, `dot_details`), all per
    device, plus what only a dispatch count sees: the peak of the step's
    live allocations, FLOPs and bytes by aten op and the hand-written
    kernels' ops."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    dot_details: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    kernel_ops: dict = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class _Counter(TorchDispatchMode):
    """The mode behind `analyze_step`. Inside a `kernel_op` scope the ops of
    a kernel's plain version add their FLOPs to the scope and nothing else
    (the kernel neither moves their bytes nor holds their temporaries)."""

    def __init__(self, keep_top_dots: int):
        super().__init__()
        self.costs = HloCosts()
        self.keep = keep_top_dots
        self.dots: dict[str, float] = defaultdict(float)
        self.by_op: dict[str, float] = defaultdict(float)
        self.bytes_by_op: dict[str, float] = defaultdict(float)
        self.scopes: list[list[float]] = []
        self.live: dict[int, tuple] = {}       # storage id -> (ref, bytes)
        self.shapes: dict = {}                 # see `_run`
        self.live_bytes = 0
        self.swept = 0

    # -- memory -------------------------------------------------------
    # `live_bytes` counts every tracked storage, the dead ones too until a
    # sweep drops them: an upper bound of the live bytes. The peak is
    # exact all the same, as a sweep runs whenever the bound would pass it
    # (and when the table has doubled since the last one).
    def _sweep(self):
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]
        self.swept = len(self.live)

    def _track(self, outs, args):
        from torch.multiprocessing.reductions import StorageWeakRef
        new = {}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in self.live:
                new[st._cdata] = (StorageWeakRef(st), st.nbytes())
        if not new:
            return
        for t in _tensors(args):                # aliases of an operand
            new.pop(t.untyped_storage()._cdata, None)
        added = sum(n for _, n in new.values())
        if self.live_bytes + added > self.costs.peak_bytes \
                or len(self.live) > 2 * self.swept + 64:
            self._sweep()
        self.live.update(new)
        self.live_bytes += added
        self.costs.peak_bytes = max(self.costs.peak_bytes, self.live_bytes)

    # -- counting -----------------------------------------------------
    def add_flops(self, name: str, flops: float, sig: str | None = None):
        if self.scopes:
            self.scopes[-1][0] += flops
            return
        self.costs.flops += flops
        self.by_op[name] += flops
        if sig is not None:
            self.dots[sig] += flops

    def add_collective(self, kind: str, nbytes: int):
        c = self.costs
        c.collective_bytes[kind] = c.collective_bytes.get(kind, 0) + nbytes
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run it: its local ops (and the collectives its
            # redistributions issue) come back through this mode
            return NotImplemented
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) \
                is not None:
            # DTensor's sharding propagation running the op on fake
            # tensors of the global shape: not the step's work
            return func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return func(*args, **kwargs)
        out = self._run(func, args, kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.add_collective(kind, tensor_bytes(out))
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            ins = [t for t in args if isinstance(t, torch.Tensor)]
            sig = f"{name} {' x '.join(_shape_str(t) for t in ins)} -> " \
                  f"{_shape_str(out) if isinstance(out, torch.Tensor) else ''}"
            self.add_flops(name, f, sig)
        if self.scopes:
            return out
        nbytes = self._bytes(func, name, args, kwargs, out)
        self.costs.bytes_accessed += nbytes
        self.bytes_by_op[name] += nbytes
        self._track(list(_tensors(out)), (args, kwargs))
        return out

    def _run(self, func, args, kwargs):
        """`func(*args, **kwargs)`; a functional op on meta tensors whose
        operands' shapes, strides and dtypes were seen before returns fresh
        meta outputs of the shapes it gave then (a meta kernel only
        computes shapes, and a step repeats its ops many times over)."""
        key = _cache_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        spec = self.shapes.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            spec = _out_spec(out)
            # cached only where fresh outputs are what the op gives: no
            # output shares a storage with an operand or another output,
            # and each storage is the least its shape needs
            held = [st.untyped_storage()._cdata for st in _tensors(args)]
            got = [t.untyped_storage() for t in _tensors(out)]
            if spec is None or len({st._cdata for st in got}) < len(got) \
                    or any(st._cdata in held for st in got) \
                    or [st.nbytes() for st in got] != [
                        t.untyped_storage().nbytes()
                        for t in _tensors(_from_spec(spec))]:
                spec = False
            self.shapes[key] = spec
            return out
        if spec is False:
            return func(*args, **kwargs)
        return _from_spec(spec)

    @staticmethod
    def _bytes(func, name, args, kwargs, out) -> int:
        if name in _FREE or func.is_view:
            return 0
        rets = func._schema.returns
        if rets and all(r.alias_info is not None
                        and not r.alias_info.is_write for r in rets):
            return 0                           # unbind, split, ...: views
        if name in _GATHERS:
            return 2 * tensor_bytes(list(_tensors(out))) \
                + tensor_bytes(list(_tensors((args[1:], kwargs))))
        if name in _SCATTER_WRITES:
            # the update (source, values, indices) read once and written
            # once
            return 2 * tensor_bytes(list(_tensors((args[1:], kwargs))))
        return tensor_bytes(list(_tensors((args, kwargs)))) \
            + tensor_bytes(list(_tensors(out)))

    def finish(self) -> HloCosts:
        c = self.costs
        c.dot_details = sorted(self.dots.items(), key=lambda kv: -kv[1])
        c.dot_details = [[k, v] for k, v in c.dot_details[:self.keep]]
        c.flops_by_op = dict(self.by_op)
        c.bytes_by_op = dict(self.bytes_by_op)
        return c


def _functional(func) -> bool:
    s = func._schema
    return func.namespace == "aten" and not s.is_mutable and all(
        a.alias_info is None for a in (*s.arguments, *s.returns))


def _freeze(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta" or type(x) is not torch.Tensor:
            raise TypeError
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(y) for y in x)
    hash(x)
    return x


def _cache_key(func, args, kwargs):
    if not _functional(func):
        return None
    try:
        return (func, _freeze(args),
                tuple(sorted((k, _freeze(v)) for k, v in kwargs.items())))
    except TypeError:
        return None


def _out_spec(out):
    """Shapes, strides and dtypes of meta outputs (None: not cached)."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) \
            if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)) and out and all(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            for t in out):
        return [_out_spec(t) for t in out]
    return None


def _from_spec(spec):
    if isinstance(spec, list):
        return tuple(_from_spec(s) for s in spec)
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


_ACTIVE = threading.local()


def _active() -> _Counter | None:
    return getattr(_ACTIVE, "counter", None)


@contextlib.contextmanager
def _counting(counter: _Counter):
    prev = _active()
    _ACTIVE.counter = counter
    try:
        with counter:
            yield counter
    finally:
        _ACTIVE.counter = prev


def analyze_step(fn, *args, keep_top_dots: int = 24, **kw) -> HloCosts:
    """Run `fn(*args, **kw)` once under the counting mode and return its
    per-device costs. Pass meta tensors (or DTensors over meta shards):
    real tensors would be computed on."""
    counter = _Counter(keep_top_dots)
    with _counting(counter):
        fn(*args, **kw)
    return counter.finish()


def kernel_op(name: str, plain, in_bytes: int, *args, flops=None,
              **kwargs):
    """A hand-written kernel's call on meta tensors: `plain(*args,
    **kwargs)` gives the outputs' shapes and dtypes, and inside
    `analyze_step` the call counts as one op named `name`: the FLOPs of the
    plain version's products (or `flops`, where they depend on the data)
    and the bytes the kernel moves, `in_bytes` read (its operands on this
    rank) and its outputs written. Outside `analyze_step` it only returns
    the meta outputs."""
    counter = _active()
    if counter is None:
        return plain(*args, **kwargs)
    counter.scopes.append([0.0])
    try:
        out = plain(*args, **kwargs)
    finally:
        counted = counter.scopes.pop()[0]
    flops = counted if flops is None else flops
    outs = [_local(t) for t in _tensors(out)]
    nbytes = in_bytes + tensor_bytes(outs)
    counter.add_flops(name, flops)
    counter.costs.bytes_accessed += nbytes
    counter.bytes_by_op[name] += nbytes
    k = counter.costs.kernel_ops.setdefault(
        name, {"calls": 0, "flops": 0.0, "bytes": 0})
    k["calls"] += 1
    k["flops"] += flops
    k["bytes"] += nbytes
    counter._track(outs, (args, kwargs))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t
