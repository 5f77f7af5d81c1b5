"""Permutation calibration: MassDiff (Algorithm 1) and baselines.

MassDiff greedily assigns coordinates (in descending average-magnitude order)
to the block whose running average ℓ₁ mass is smallest, equalizing the
expected per-block ℓ₁ norms — the quantity that governs the Prop-3.2 bound.

Baselines reproduced for Table 6: identity, random, absmax (descending sort),
and ZigZag (Lin et al. 2024a — serpentine round-robin assignment).

Conventions
-----------
A permutation is an index array ``perm`` of shape [d] such that the permuted
vector is ``x[..., perm]`` — i.e. output coordinate i reads input coordinate
``perm[i]``. Block j then owns output coordinates [j·b, (j+1)·b).
The matching permutation matrix is ``P = I[:, perm]`` so ``x @ P == x[..., perm]``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "coordinate_mass",
    "massdiff",
    "massdiff_torch",
    "zigzag",
    "absmax",
    "random_permutation",
    "identity",
    "perm_matrix",
    "invert",
    "block_l1_norms",
    "make_permutation",
]


def coordinate_mass(calib) -> np.ndarray:
    """Average magnitude per coordinate over a calibration set.

    `calib` is [num_tokens, d] (tokens pooled over the calibration sequences);
    returns μ_i = (1/m)·Σ_k |X_i^{(k)}|, the per-coordinate mean mass. Because
    per-block ℓ₁ norms are additive in coordinates, Algorithm 1's expected
    max-block objective depends on the calibration data only through μ.
    """
    if torch.is_tensor(calib):
        # on the tensor's device, in f64 as numpy would sum it
        a = calib.detach().to(torch.float64)
        if a.dim() == 1:
            a = a[None, :]
        return a.abs().mean(dim=0).cpu().numpy()
    a = np.asarray(calib, dtype=np.float64)
    if a.ndim == 1:
        a = a[None, :]
    return np.mean(np.abs(a), axis=0)


def massdiff(mass: np.ndarray, block_size: int) -> np.ndarray:
    """Algorithm 1 (MassDiff): greedy mass diffusion.

    Sort coordinates by descending mean mass; assign each to the non-full
    block with the smallest running mass (LPT-style makespan balancing).
    Returns the permutation index array (see module docstring convention).
    """
    mass = np.asarray(mass, dtype=np.float64)
    d = mass.shape[0]
    if d % block_size:
        raise ValueError(f"d={d} not divisible by b={block_size}")
    n = d // block_size
    order = np.argsort(-mass, kind="stable")
    sums = np.zeros(n)
    members: list[list[int]] = [[] for _ in range(n)]
    open_sums = sums.copy()
    for i in order:
        j = int(np.argmin(open_sums))
        members[j].append(int(i))
        sums[j] += mass[i]
        open_sums[j] = sums[j]
        if len(members[j]) == block_size:
            open_sums[j] = np.inf
    perm = np.concatenate([np.asarray(m, dtype=np.int64) for m in members])
    return perm


def massdiff_torch(mass: torch.Tensor, block_size: int) -> torch.Tensor:
    """MassDiff on the tensor's device - the twin of the reference's
    `massdiff_jax` (the same greedy loop, argmin taking the first index;
    the running sums in f32). Equal to `massdiff` up to ties of the
    f32 sums."""
    d = mass.shape[0]
    n = d // block_size
    dev = mass.device
    mass = mass.to(torch.float32)
    order = torch.argsort(-mass, stable=True)
    sums = torch.zeros((n,), dtype=torch.float32, device=dev)
    counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    block_of = torch.zeros((d,), dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for step in range(d):
        i = order[step]
        j = torch.argmin(torch.where(counts < block_size, sums, inf))
        sums[j] += mass[i]
        counts[j] += 1
        block_of[i] = j
    # coordinates sorted by (block, descending mass): a stable sort on the
    # block id over the descending-mass order keeps each block's insertion
    # order
    return order[torch.argsort(block_of[order], stable=True)]


def zigzag(mass: np.ndarray, block_size: int) -> np.ndarray:
    """ZigZag (Lin et al. 2024a): descending sort, serpentine round-robin.

    Coordinate ranks 0..d-1 are dealt across blocks 0,1,..,n-1,n-1,..,1,0,0,..
    so each block receives one coordinate per half-sweep.
    """
    mass = np.asarray(mass, dtype=np.float64)
    d = mass.shape[0]
    n = d // block_size
    order = np.argsort(-mass, kind="stable")
    fwd = np.arange(n)
    pattern = np.concatenate([fwd, fwd[::-1]])
    blocks = np.tile(pattern, d // (2 * n) + 1)[:d]
    members: list[list[int]] = [[] for _ in range(n)]
    for rank, i in enumerate(order):
        members[blocks[rank]].append(int(i))
    perm = np.concatenate([np.asarray(m, dtype=np.int64) for m in members])
    return perm


def absmax(calib: np.ndarray, block_size: int) -> np.ndarray:
    """Absmax baseline: descending order of max |x| over the calibration set,
    chunked into contiguous blocks."""
    if torch.is_tensor(calib):
        calib = calib.detach().to(torch.float32).cpu().numpy()
    a = np.asarray(calib)
    if a.ndim == 1:
        a = a[None, :]
    m = np.max(np.abs(a), axis=0)
    return np.argsort(-m, kind="stable").astype(np.int64)


def random_permutation(d: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(d).astype(np.int64)


def identity(d: int) -> np.ndarray:
    return np.arange(d, dtype=np.int64)


def perm_matrix(perm: np.ndarray) -> np.ndarray:
    """P such that x @ P == x[..., perm] (columns are unit vectors e_{perm[i]})."""
    d = len(perm)
    P = np.zeros((d, d), dtype=np.float32)
    P[np.asarray(perm), np.arange(d)] = 1.0
    return P


def invert(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(np.asarray(perm))
    inv[np.asarray(perm)] = np.arange(len(perm))
    return inv


def block_l1_norms(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block l1 norms over the last axis: [..., n]."""
    d = x.shape[-1]
    g = x.reshape(*x.shape[:-1], d // block_size, block_size)
    return g.abs().sum(dim=-1)


def make_permutation(method: str, calib: np.ndarray, block_size: int,
                     *, seed: int = 0) -> np.ndarray:
    """Dispatch: method ∈ {massdiff, zigzag, absmax, random, identity}."""
    d = calib.shape[-1]
    if method == "identity":
        return identity(d)
    if method == "random":
        return random_permutation(d, seed)
    if method == "absmax":
        return absmax(calib, block_size)
    mass = coordinate_mass(calib)
    if method == "massdiff":
        return massdiff(mass, block_size)
    if method == "zigzag":
        return zigzag(mass, block_size)
    raise ValueError(f"unknown permutation method {method!r}")
