"""Dry-run cells for `tests/test_torch_launch.py`, counted in a spawned
rank (`torch_mesh_ranks.py`) so that no process group ever exists in the
test process: `collect()` gives the records of the reduced families'
cells on a one-rank mesh and on a fake (2, 4) world, llama3-1b's
decode_32k on the production (16, 16) mesh, and the collectives of a
row-parallel feed-forward counted on the (2, 4) world. `python
tests/torch_dryrun_cells.py` (the port on the path) prints them as JSON.
"""
import json
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun, hlo_analysis, mesh

BATCH, SEQ = 8, 64
# (arch, shape, quantized_serve) of the reduced families
CELLS = [
    ("llama3-1b", "train_4k", False),
    ("llama3-1b", "prefill_32k", False),
    ("llama3-1b", "decode_32k", False),
    ("llama3-1b", "decode_32k", True),
    ("llama3-1b", "long_500k", False),
    ("qwen1.5-0.5b", "prefill_32k", False),
    ("deepseek-moe-16b", "prefill_32k", False),
    ("deepseek-moe-16b", "decode_32k", False),
    ("mamba2-1.3b", "prefill_32k", False),
    ("mamba2-1.3b", "long_500k", False),
    ("zamba2-1.2b", "decode_32k", False),
    ("internvl2-2b", "prefill_32k", False),
    ("hubert-xlarge", "prefill_32k", False),
    ("hubert-xlarge", "decode_32k", False),
]


def row_parallel_ffn():
    """A SwiGLU feed-forward on the (2, 4) world: w_gate and w_up split by
    columns, w_down by rows over "model", the batch over "data"."""
    from repro_torch.distributed.context import (Mesh, NamedSharding, P,
                                                 mesh_context)
    from repro_torch.models import layers as L
    m = Mesh(np.arange(8).reshape(2, 4), ("data", "model"),
             device_type="cuda")
    d, f = 128, 256

    def meta(*shape):
        return torch.empty(shape, device="meta")

    with mesh_context(m):
        x = dryrun._place(meta(BATCH, SEQ, d), NamedSharding(m, P("data")))
        p = {"w_gate": dryrun._place(meta(d, f),
                                     NamedSharding(m, P(None, "model"))),
             "w_up": dryrun._place(meta(d, f),
                                   NamedSharding(m, P(None, "model"))),
             "w_down": dryrun._place(meta(f, d),
                                     NamedSharding(m, P("model", None)))}
        c = hlo_analysis.analyze_step(L.mlp, x, p, "silu")
    return {"collective_bytes": c.collective_bytes,
            "collective_counts": c.collective_counts, "flops": c.flops,
            "batch": BATCH, "seq": SEQ, "d": d, "f": f}


# rows that do not divide the (2, 4) world's 2 data ranks: one sequence
# of a long decode; a ZeRO-3 arch's micro-batch of one row (padded to two)
UNEVEN = [("zamba2-1.2b", "long_500k", 1, None),
          ("deepseek-coder-33b", "train_4k", 2, 2)]


def cell_record(arch, cell, shape, quantized, batch=BATCH, micro=None):
    try:
        return dryrun.dry_run_cell(arch, cell, multi_pod=False,
                                   mesh_shape=shape, reduced=True,
                                   batch=batch, seq=SEQ, microbatches=micro,
                                   quantized_serve=quantized)
    except Exception:
        return {"arch": arch, "shape": cell, "status": "fail",
                "error": traceback.format_exc(limit=20)}


def collect(part: int | None = None) -> dict:
    """The records; `part` 0 or 1 gives one half of them (the one-rank
    mesh and the production cell, or the (2, 4) world)."""
    out = {"cells": {}}
    if part in (None, 0):
        with dryrun.fake_world(1):
            # train counts only on the (2, 4) world: the one-rank count's
            # FLOPs come from the forward cells
            out["cells"]["1x1"] = [cell_record(arch, cell, (1, 1), q)
                                   for arch, cell, q in CELLS
                                   if cell != "train_4k"]
        with dryrun.fake_world(mesh.device_count_required(False)):
            out["production"] = dryrun.dry_run_cell(
                "llama3-1b", "decode_32k", multi_pod=False)
    if part in (None, 1):
        with dryrun.fake_world(8):
            out["cells"]["2x4"] = [cell_record(arch, cell, (2, 4), q)
                                   for arch, cell, q in CELLS]
            out["uneven"] = [cell_record(arch, cell, (2, 4), False, b, n)
                             for arch, cell, b, n in UNEVEN]
            out["row_parallel_ffn"] = row_parallel_ffn()
    out["group_at_end"] = dist.is_initialized()
    return out


if __name__ == "__main__":
    print(json.dumps(collect()))
    sys.exit(0)
