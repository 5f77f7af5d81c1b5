"""Production mesh construction.

A FUNCTION (not a module-level constant) so importing this module creates
no process group and no `DeviceMesh`: `make_production_mesh` returns the
port's `Mesh` of ranks, whose `DeviceMesh` is made on first use, once a
process group exists (`launch/dryrun.py` makes a fake world of that size).

The shapes are the reference's TPU pod meshes: (16, 16) data x model, 256
chips, and (2, 16, 16) pod x data x model, 512. On H100s, 256 cards are 32
nodes of 8 joined by NVLink inside a node and InfiniBand between nodes, so
a 16-wide axis spans two NVLink domains and every collective over a mesh
axis crosses the network (`launch/roofline.py` prices it so).
"""
from __future__ import annotations

import numpy as np

from ..distributed.context import Mesh

SINGLE_POD = (16, 16)            # 256 ranks
MULTI_POD = (2, 16, 16)          # 512 ranks


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.arange(device_count_required(multi_pod)).reshape(shape),
                axes, device_type=device_type)


def device_count_required(multi_pod: bool) -> int:
    shape = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    return n
