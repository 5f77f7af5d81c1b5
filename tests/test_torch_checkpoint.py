"""The port's checkpoints (`repro_torch.checkpoint.manager`): the JAX
package's file format both ways, bit for bit, f32 and bf16 leaves alike;
retention, async saves and atomic publication.

The reference cannot restore a bf16 leaf into a target (its `astype` from
the 2-byte void the npz holds raises); that is held here as the
reference's own behaviour, so that a fix on either side is seen.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.tree import flatten_with_paths


def _tree(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return {"params": {"layers": {"w": torch.randn(2, 3, 4, generator=g).to(dtype),
                                  "b": torch.randn(2, 4, generator=g).to(dtype)},
                       "embed": torch.randn(5, 4, generator=g).to(dtype)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


def _jax_tree(tree):
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(conv, tree)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip(tmp_path, dtype):
    tree = _tree(dtype)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(100, tree, blocking=True)
    like = _tree(dtype)
    for leaf in (like["params"]["embed"], like["params"]["layers"]["w"]):
        leaf.zero_()
    _assert_equal(mgr.restore(target=like), tree)
    flat = mgr.restore()
    assert sorted(flat) == sorted(["params::layers::w", "params::layers::b",
                                   "params::embed", "opt::step"])
    assert torch.equal(_bits(flat["params::embed"]),
                       _bits(tree["params"]["embed"]))
    man = json.load(open(tmp_path / "step_000000100" / "manifest.json"))
    assert man["leaves"]["params::embed"]["dtype"] == str(dtype).split(".")[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reads_the_references_checkpoints(tmp_path, dtype):
    tree = _tree(dtype)
    JManager(str(tmp_path)).save(5, _jax_tree(tree), blocking=True)
    _assert_equal(CheckpointManager(str(tmp_path)).restore(target=_tree(dtype)),
                  tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_reference_reads_the_ports_bytes(tmp_path, dtype):
    tree = _tree(dtype)
    CheckpointManager(str(tmp_path / "port")).save(5, tree, blocking=True)
    JManager(str(tmp_path / "ref")).save(5, _jax_tree(tree), blocking=True)
    got = JManager(str(tmp_path / "port")).restore()
    want = JManager(str(tmp_path / "ref")).restore()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()
    mp = json.load(open(tmp_path / "port" / "step_000000005" / "manifest.json"))
    mr = json.load(open(tmp_path / "ref" / "step_000000005" / "manifest.json"))
    assert mp["leaves"] == mr["leaves"]
    if dtype == torch.float32:
        # the reference restores the port's f32 tree into its own target
        r = JManager(str(tmp_path / "port")).restore(target=_jax_tree(tree))
        for a, b in zip(jax.tree.leaves(r), jax.tree.leaves(_jax_tree(tree))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_cannot_restore_bf16_into_a_target(tmp_path):
    """R7: the reference's own behaviour, from its own checkpoint."""
    tree = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    mgr = JManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(target=tree)


def test_retention_latest_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"p": torch.ones(4) * s})
    mgr.wait()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    r = mgr.restore(target={"p": torch.zeros(4)})
    assert torch.equal(r["p"], 4 * torch.ones(4))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert mgr.restore(step=3)["p"].tolist() == [3.0] * 4


def test_the_save_copies_before_returning(tmp_path):
    t = torch.ones(8)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"t": t})
    t.fill_(7.0)                        # the caller may change it at once
    assert torch.equal(mgr.restore(target={"t": torch.zeros(8)})["t"],
                       torch.ones(8))


def test_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    mgr.save(1, {"t": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # reported once


def test_restore_refuses_mismatches(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(1, {"t": torch.ones(2)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(target={"t": torch.ones(3)})
    with pytest.raises(KeyError):
        mgr.restore(target={"u": torch.ones(2)})
