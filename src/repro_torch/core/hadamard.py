"""Hadamard matrix constructions (numpy, host side).

  * Sylvester construction for power-of-2 orders.
  * Paley I  (q prime, q = 3 mod 4  -> order q+1).
  * Paley II (q prime, q = 1 mod 4  -> order 2(q+1)).
  * General `hadamard(n)` for n = 2^a * m via Kronecker(Sylvester, Paley base).

Entries are +-1 (int8); callers normalise by 1/sqrt(n). The constructions
run when a rotation operand is built, never per step. Below them: the
rotations as tensor functions (`fwht`, `hadamard_transform`,
`block_hadamard_transform`; plain PyTorch, the fake-quant model's online
R3 and the pipeline's merges) and the op-count models of Appendix A.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["sylvester", "paley1", "paley2", "hadamard", "is_hadamard",
           "decompose_dim", "constructible", "random_orthogonal",
           "rotation_matrix", "fwht", "hadamard_transform",
           "block_hadamard_matrix", "block_hadamard_transform",
           "ops_dense_matmul", "ops_butterfly_matmul", "ops_optimized",
           "ops_block", "ops_full_vector"]


def _is_prime(q: int) -> bool:
    if q < 2:
        return False
    if q % 2 == 0:
        return q == 2
    i = 3
    while i * i <= q:
        if q % i == 0:
            return False
        i += 2
    return True


@functools.lru_cache(maxsize=None)
def sylvester(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix of power-of-2 order n (entries ±1)."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"Sylvester order must be a power of 2, got {n}")
    H = np.array([[1]], dtype=np.int8)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H.astype(np.int8)


def _jacobsthal(q: int) -> np.ndarray:
    """Jacobsthal matrix Q[i,j] = χ(j - i) over GF(q), χ the Legendre symbol."""
    residues = np.zeros(q, dtype=np.int8)
    squares = set((i * i) % q for i in range(1, q))
    for a in range(1, q):
        residues[a] = 1 if a in squares else -1
    idx = (np.arange(q)[None, :] - np.arange(q)[:, None]) % q
    return residues[idx]


@functools.lru_cache(maxsize=None)
def paley1(q: int) -> np.ndarray:
    """Paley construction I: Hadamard of order q+1 for prime q ≡ 3 (mod 4)."""
    if not _is_prime(q) or q % 4 != 3:
        raise ValueError(f"Paley I needs prime q ≡ 3 mod 4, got {q}")
    n = q + 1
    Q = _jacobsthal(q)
    S = np.zeros((n, n), dtype=np.int8)
    S[0, 1:] = 1
    S[1:, 0] = -1
    S[1:, 1:] = Q
    H = S + np.eye(n, dtype=np.int8)
    return H.astype(np.int8)


@functools.lru_cache(maxsize=None)
def paley2(q: int) -> np.ndarray:
    """Paley construction II: Hadamard of order 2(q+1) for prime q ≡ 1 (mod 4)."""
    if not _is_prime(q) or q % 4 != 1:
        raise ValueError(f"Paley II needs prime q ≡ 1 mod 4, got {q}")
    n = q + 1
    Q = _jacobsthal(q)
    S = np.zeros((n, n), dtype=np.int8)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    # Substitute: 0 → [[1,-1],[-1,-1]], ±1 → ±[[1,1],[1,-1]].
    # For Paley-II S the zeros sit exactly on the diagonal.
    pos = np.array([[1, 1], [1, -1]], dtype=np.int8)
    zer = np.array([[1, -1], [-1, -1]], dtype=np.int8)
    H = np.kron(S, pos)
    for i in range(n):
        H[2 * i : 2 * i + 2, 2 * i : 2 * i + 2] = zer
    return H.astype(np.int8)


def is_hadamard(H: np.ndarray) -> bool:
    n = H.shape[0]
    if H.shape != (n, n) or not np.all(np.abs(H) == 1):
        return False
    G = H.astype(np.int64) @ H.astype(np.int64).T
    return bool(np.array_equal(G, n * np.eye(n, dtype=np.int64)))


@functools.lru_cache(maxsize=None)
def decompose_dim(d: int) -> tuple[int, int]:
    """Split d = k · t with t the odd part and k the power-of-2 part."""
    t = d
    while t % 2 == 0:
        t //= 2
    return d // t, t


@functools.lru_cache(maxsize=None)
def _base_order_for(t: int, max_pow: int) -> tuple[np.ndarray, int] | None:
    """Find a Paley-constructible Hadamard of order t·2^s for the smallest s ≤ max_pow."""
    for s in range(0, max_pow + 1):
        order = t << s
        if order == 1:
            return sylvester(1), 0
        if order % 4 != 0 and order not in (1, 2):
            continue
        q = order - 1
        if _is_prime(q) and q % 4 == 3:
            return paley1(q), s
        if order % 2 == 0:
            q = order // 2 - 1
            if _is_prime(q) and q % 4 == 1:
                return paley2(q), s
    return None


@functools.lru_cache(maxsize=None)
def hadamard(n: int) -> np.ndarray:
    """Hadamard matrix of order n (entries ±1). Raises ValueError when the
    Sylvester/Paley toolbox cannot construct it (callers may fall back to
    `random_orthogonal`)."""
    if n < 1:
        raise ValueError("order must be positive")
    if n == 1:
        return np.array([[1]], dtype=np.int8)
    if n == 2:
        return np.array([[1, 1], [1, -1]], dtype=np.int8)
    if n % 4 != 0:
        raise ValueError(f"No Hadamard matrix of order {n} (n % 4 != 0)")
    k, t = decompose_dim(n)
    if t == 1:
        return sylvester(n)
    a = int(math.log2(k))
    found = _base_order_for(t, a)
    if found is None:
        raise ValueError(f"Cannot construct Hadamard of order {n} = 2^{a}·{t}")
    base, s = found
    rem = a - s
    H = np.kron(sylvester(1 << rem), base).astype(np.int8)
    return H


def constructible(n: int) -> bool:
    """True when `hadamard(n)` can build the order without materialising
    it."""
    if n in (1, 2):
        return True
    if n < 1 or n % 4 != 0:
        return False
    k, t = decompose_dim(n)
    if t == 1:
        return True
    return _base_order_for(t, int(math.log2(k))) is not None


def random_orthogonal(n: int, gen: torch.Generator) -> torch.Tensor:
    """Haar-random orthogonal matrix from `gen`, on its device (the
    fallback rotation for orders without a construction)."""
    g = torch.randn((n, n), generator=gen, device=gen.device,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))[None, :]


def rotation_matrix(n: int, *, gen: torch.Generator | None = None,
                    dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Normalised rotation of order n: Hadamard when constructible, else a
    Haar-random orthogonal fallback (needs `gen`)."""
    try:
        h = hadamard(n).astype(np.float32) / np.sqrt(n)
        return torch.from_numpy(h).to(device=device, dtype=dtype)
    except ValueError:
        if gen is None:
            raise
        return random_orthogonal(n, gen).to(dtype)


# ---------------------------------------------------------------------------
# Application (plain PyTorch)
# ---------------------------------------------------------------------------

def _scale(n: int, dtype) -> float:
    """1/sqrt(n) rounded to `dtype` (the reference's scalar of x's dtype),
    as a Python float: multiplying by it copies nothing to the device, so
    the transforms can run inside a CUDA graph capture."""
    return float(torch.tensor(1.0 / math.sqrt(n), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _base_operand(n: int, device, dtype) -> torch.Tensor:
    """The +-1 Hadamard of order n on `device`, made once per (order,
    device, dtype): the first (eager) call of a captured step makes it."""
    return torch.from_numpy(hadamard(n).astype(np.float32)).to(device, dtype)


def fwht(x: torch.Tensor, *, normalize: bool = True) -> torch.Tensor:
    """Fast Walsh-Hadamard transform over the last axis (power-of-2
    length): `x @ sylvester(d)` (and /sqrt(d) when normalised), as
    log2(d) butterfly stages."""
    shape = x.shape
    d = shape[-1]
    if d & (d - 1):
        raise ValueError(f"fwht needs power-of-2 length, got {d}")
    y = x.reshape(-1, d)
    h = 1
    while h < d:
        y = y.reshape(-1, d // (2 * h), 2, h)
        a, b = y[:, :, 0, :], y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2)
        h *= 2
    y = y.reshape(shape)
    return y * _scale(d, x.dtype) if normalize else y


def hadamard_transform(x: torch.Tensor, *,
                       normalize: bool = True) -> torch.Tensor:
    """Full-vector Hadamard rotation over the last axis for any
    constructible d: the butterfly for a power of 2, else (Appendix A.1)
    dense base-order rotations on the inner axis and butterflies across the
    outer 2^k' axis (H_d = H_2^k' (x) H_base)."""
    d = x.shape[-1]
    if d & (d - 1) == 0:
        return fwht(x, normalize=normalize)
    k, t = decompose_dim(d)
    found = _base_order_for(t, int(math.log2(k)))
    if found is None:
        raise ValueError(f"No Hadamard construction for d={d}")
    base, s = found
    base_order = t << s
    outer = d // base_order
    shape = x.shape
    y = x.reshape(-1, outer, base_order)
    y = torch.einsum("rob,bc->roc", y,
                     _base_operand(base_order, x.device, x.dtype))
    y = fwht(y.transpose(-1, -2), normalize=False)
    y = y.transpose(-1, -2).reshape(shape)
    return y * _scale(d, x.dtype) if normalize else y


def block_hadamard_matrix(d: int, b: int, dtype=torch.float32,
                          device="cpu") -> torch.Tensor:
    """Materialised I_n (x) H_b (normalised), built on `device`."""
    if d % b:
        raise ValueError(f"d={d} not divisible by b={b}")
    hb = torch.from_numpy(hadamard(b).astype(np.float32) / np.sqrt(b))
    eye = torch.eye(d // b, dtype=torch.float32, device=device)
    return torch.kron(eye, hb.to(device)).to(dtype)


def block_hadamard_transform(x: torch.Tensor, b: int, *,
                             normalize: bool = True) -> torch.Tensor:
    """The block rotation X (I_n (x) H_b) over the last axis, in plain
    PyTorch (`kernels.ops.block_hadamard` is the hand-written kernel)."""
    d = x.shape[-1]
    if d % b:
        raise ValueError(f"d={d} not divisible by b={b}")
    y = x.reshape(*x.shape[:-1], d // b, b)
    if b & (b - 1) == 0:
        return fwht(y, normalize=normalize).reshape(x.shape)
    hb = _base_operand(b, x.device, x.dtype)
    if normalize:
        hb = hb * _scale(b, x.dtype)
    return torch.einsum("...nb,bc->...nc", y, hb).reshape(x.shape)


# ---------------------------------------------------------------------------
# Op-count models (paper Appendix A, Tables 3 & 4)
# ---------------------------------------------------------------------------

def _kprime_t(d: int) -> tuple[int, int]:
    """k' and t with d = 2^k' * 4t, t the odd part (App. A.1)."""
    k, t = decompose_dim(d)
    if t == 1:
        return int(math.log2(d)), 0
    return int(math.log2(k)) - 2, t


def ops_dense_matmul(d: int) -> int:
    """Dense rotation matmul: d^2 multiply-accumulates."""
    return d * d


def ops_butterfly_matmul(d: int) -> int:
    """Butterfly stages + dense 4t-dim base matmuls: d*k' add/subs +
    2^k' * 4t*(4t-1) base ops."""
    kprime, t = _kprime_t(d)
    if t == 0:
        return d * int(math.log2(d))
    return d * kprime + (1 << kprime) * (4 * t) * (4 * t - 1)


def ops_optimized(d: int) -> int:
    """The paper's optimised non-power-of-2 rotation: d*(k' + t + 2) ops;
    a power of 2 is the plain butterfly d*log2(d)."""
    kprime, t = _kprime_t(d)
    if t == 0:
        return d * int(math.log2(d))
    return d * (kprime + t + 2)


def ops_block(d: int, b: int) -> int:
    """Block Hadamard rotation: d*log2(b) add/subs (power-of-2 b)."""
    if b & (b - 1):
        raise ValueError("block size must be a power of 2 for the FWHT count")
    return d * int(math.log2(b))


def ops_full_vector(d: int) -> int:
    """Least ops for a full-vector rotation: the optimised count."""
    return ops_optimized(d)
