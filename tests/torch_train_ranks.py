"""The ranks of `test_torch_train_mesh.py`, in a module of their own so that
a spawned rank imports torch and the port only.

Four gloo ranks run the training launcher (`repro_torch.launch.train`)
on sharded meshes, one run after another in one process group:

- tensor-parallel llama3-1b on (2, 2) and (1, 4) meshes, and ZeRO-3
  deepseek-coder-33b and llama4-maverick on (4, 1) and (2, 2) ones (the
  reduced configs; 3 steps of 2 micro-batches with remat): each step's
  loss, the first step's gradients and the final parameters, whole; each
  parameter's and AdamW moment's local and global element counts; whether
  the final checkpoint restores onto the run's own layout bit for bit;
- the (2, 2) tensor-parallel and ZeRO-3 checkpoints resumed on a (1, 4)
  mesh, and the JAX launcher's step-0 checkpoint resumed on (2, 2);
- a (2, 2) run whose step fails on rank 1 alone, after each of its
  collectives, on every attempt of the third step.

Each rank writes its results to `<out>/rank<r>.pt`; the test process
compares them with one-process runs.
"""
import contextlib
import io
import os
import shutil

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train as LT
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_paths, leaves

COMMON = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
          "--checkpoint-every", "2"]
STEPS = 3
TRAIN = COMMON + ["--microbatches", "2", "--remat", "--steps", str(STEPS)]
# name: (arch, --model-parallel); four ranks make a (4 / mp, mp) mesh
CASES = {"tp_2x2": ("llama3-1b", 2), "tp_1x4": ("llama3-1b", 4),
         "z3_4x1_deepseek": ("deepseek-coder-33b", 1),
         "z3_2x2_deepseek": ("deepseek-coder-33b", 2),
         "z3_4x1_maverick": ("llama4-maverick-400b-a17b", 1),
         "z3_2x2_maverick": ("llama4-maverick-400b-a17b", 2)}
# a (2, 2) run's checkpoint resumed on (1, 4) for RESUME_STEPS steps
ELASTIC = {"tp_2x2": "tp_2x2_on_1x4", "z3_2x2_deepseek": "z3_2x2_on_1x4"}
RESUME_STEPS = 2
# the JAX launcher's step-0 checkpoint (written by the test process)
# resumed on (2, 2) with the launcher's defaults
REF_RESUME = ["--arch", "llama3-1b", "--model-parallel", "2", "--steps",
              str(RESUME_STEPS)] + COMMON
# rank 1's step fails on these calls (the third step's three attempts)
FAIL_RANK, FAIL_CALLS = 1, (3, 4, 5)


def whole(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _local(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _paths(tree) -> dict:
    return {"/".join(map(str, p)): v for p, v in flatten_with_paths(tree)}


class Collectives:
    """Records each collective that DTensor issues in the block, as (name,
    elements of this rank's operand)."""

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        calls = self.calls = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if DTensor in types:    # DTensor first: its local ops and
                    return NotImplemented   # collectives come back here
                name = func.__name__.split(".")[0]
                if func.namespace == "_c10d_functional" \
                        and name != "wait_tensor" and name[0] != "_":
                    calls.append((name, args[0].numel()))
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def launch(argv, *, fail_calls=()):
    """`LT.main(argv)` in this process, recording each step's loss, the
    first step's gradients, the collectives of its AdamW update and the
    printed lines; the step raises on the calls numbered in `fail_calls`,
    after it ran."""
    make, apply = LT.make_train_step, adamw.apply_updates
    losses, grads, comms, calls = [], {}, [], []

    def make_step(*a, **k):
        step = make(*a, **k)

        def recorded(p, o, b):
            calls.append(None)
            out = step(p, o, b)
            if len(calls) in fail_calls:
                raise RuntimeError("injected failure after the step")
            losses.append(float(out[-1]["loss"]))
            return out
        return recorded

    def apply_updates(cfg, params, g, state):
        if grads:
            return apply(cfg, params, g, state)
        grads.update({k: whole(v) for k, v in _paths(g).items()})
        with Collectives() as seen:
            out = apply(cfg, params, g, state)
        comms.extend(seen.calls)
        return out

    buf = io.StringIO()
    LT.make_train_step, adamw.apply_updates = make_step, apply_updates
    try:
        with contextlib.redirect_stdout(buf):
            run = LT.main(argv)
    finally:
        LT.make_train_step, adamw.apply_updates = make, apply
    return run, {"losses": losses, "grads0": grads, "update_comms": comms,
                 "lines": buf.getvalue().splitlines(),
                 "failures": run["driver"].failures,
                 "restores": run["driver"].restores, "end": run["step"]}


def state_record(run, workdir) -> dict:
    """The final parameters whole, each leaf's local and global element
    counts, and whether the final checkpoint restores onto the state's
    own layout bit for bit."""
    state = {"params": run["params"], "opt": run["opt"]}
    back = CheckpointManager(os.path.join(workdir, "ckpt")).restore(
        target=state)
    same = all(
        type(a) is type(b) and getattr(a, "placements", None)
        == getattr(b, "placements", None) and a.dtype == b.dtype
        and torch.equal(_local(a), _local(b))
        for a, b in zip(leaves(back), leaves(state)))
    counts = {k: (_local(v).numel(), v.numel())
              for k, v in _paths(state).items()}
    return {"params": {k: whole(v) for k, v in _paths(run["params"]).items()},
            "counts": counts, "restored_bit_equal": same}


def rank_main(rank, world, store, out_dir, ref_ckpt):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    res = {}
    try:
        for name, (arch, mp) in CASES.items():
            work = os.path.join(out_dir, name)
            run, rec = launch(["--arch", arch, "--model-parallel", str(mp),
                               "--workdir", work] + TRAIN)
            rec.update(state_record(run, work))
            res[name] = rec
            del run
        for name, resumed in ELASTIC.items():
            work = os.path.join(out_dir, resumed)
            if rank == 0:
                shutil.copytree(os.path.join(out_dir, name, "ckpt"),
                                os.path.join(work, "ckpt"))
            dist.barrier()
            arch = CASES[name][0]
            _, res[resumed] = launch(
                ["--arch", arch, "--model-parallel", "4", "--steps",
                 str(RESUME_STEPS), "--workdir", work] + COMMON)
        work = os.path.join(out_dir, "ref_resume")
        if rank == 0:
            shutil.copytree(ref_ckpt, os.path.join(work, "ckpt",
                                                   "step_000000000"))
        dist.barrier()
        _, res["ref_resume"] = launch(REF_RESUME + ["--workdir", work])
        _, res["failing"] = launch(
            ["--arch", "llama3-1b", "--model-parallel", "2", "--workdir",
             os.path.join(out_dir, "failing")] + TRAIN,
            fail_calls=FAIL_CALLS if rank == FAIL_RANK else ())
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
