"""Hadamard matrix constructions (numpy, host side).

  * Sylvester construction for power-of-2 orders.
  * Paley I  (q prime, q = 3 mod 4  -> order q+1).
  * Paley II (q prime, q = 1 mod 4  -> order 2(q+1)).
  * General `hadamard(n)` for n = 2^a * m via Kronecker(Sylvester, Paley base).

Entries are +-1 (int8); callers normalise by 1/sqrt(n). These run when a
rotation operand is built, never per step.
"""
from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["sylvester", "paley1", "paley2", "hadamard", "is_hadamard",
           "decompose_dim"]


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
