"""Hadamard / rotation matrix construction.

Counterpart of ``compressed_tensors_tpu/transform/hadamard.py``. The
integer base matrices are built on the host as the JAX package builds
them (Sylvester for powers of 2; Paley I / Paley II over GF(q); the six
tabled orders of ``hadamard_data.py``; doubling), as int8 and cached. The
public functions return tensors on ``device`` (default the card), where
the Kronecker product with the Sylvester factor is formed. Random signs,
permutations and matrices are drawn with ``np.random.default_rng(seed)``,
as the JAX package draws them, so that both give the same bits.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "deterministic_hadamard_matrix",
    "hadamard_construction",
    "hadamard_matrix",
    "random_hadamard_matrix",
    "random_matrix",
    "high_precision_invert",
    "is_pow2",
]


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1) == 0)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(math.isqrt(n)) + 1):
        if n % p == 0:
            return False
    return True


def _prime_power(n: int):
    """(p, m) with n == p**m and p prime, or None."""
    for p in range(2, int(math.isqrt(n)) + 1):
        if n % p == 0:
            m, v = 0, n
            while v % p == 0:
                v //= p
                m += 1
            return (p, m) if v == 1 and _is_prime(p) else None
    return (n, 1) if _is_prime(n) else None


@lru_cache(maxsize=None)
def _gf_tables(q: int):
    """Field tables for GF(q), q = p^m: the subtraction table sub[i, j] ->
    element index and the quadratic-residue membership per index, with
    element 0 at index 0. Elements are polynomials over GF(p) reduced mod
    a monic irreducible of degree m (found by search)."""
    p, m = _prime_power(q)
    if m == 1:
        idx = np.arange(q)
        sub = (idx[:, None] - idx[None, :]) % q
        qr = np.zeros(q, dtype=bool)
        qr[[(i * i) % q for i in range(1, q)]] = True
        return sub, qr

    # polynomial arithmetic over GF(p), coefficients low-to-high
    def poly_mul(a, b, mod):
        res = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                res[i + j] = (res[i + j] + ai * bj) % p
        # reduce by the monic irreducible `mod` (degree m)
        while len(res) > m:
            lead = res[-1]
            if lead:
                for k in range(m + 1):
                    res[len(res) - 1 - k] = (
                        res[len(res) - 1 - k] - lead * mod[m - k]) % p
            res.pop()
        return tuple(res + [0] * (m - len(res)))

    def poly_rem(f, g):
        # remainder of f mod monic g, coefficients low-to-high over GF(p)
        f = list(f)
        dg = len(g) - 1
        while len(f) > dg:
            lead = f[-1]
            if lead:
                for k in range(dg + 1):
                    f[len(f) - 1 - k] = (f[len(f) - 1 - k]
                                         - lead * g[dg - k]) % p
            f.pop()
        return f

    def irreducible():
        # the first monic irreducible of degree m over GF(p) by trial
        # division: f is irreducible iff no monic divisor of degree
        # 1..m//2 divides it
        from itertools import product as iproduct

        divisors = [
            list(c) + [1]
            for d in range(1, m // 2 + 1)
            for c in iproduct(range(p), repeat=d)
        ]
        for coeffs in iproduct(range(p), repeat=m):
            mod = list(coeffs) + [1]  # monic
            if mod[0] == 0:  # divisible by x
                continue
            if all(any(poly_rem(mod, g)) for g in divisors):
                return mod
        raise ValueError(f"no irreducible found for GF({p}^{m})")

    mod = irreducible()
    from itertools import product as iproduct

    elements = [tuple(e) for e in iproduct(range(p), repeat=m)]
    index = {e: i for i, e in enumerate(elements)}  # (0, ..., 0) first

    sub = np.zeros((q, q), dtype=np.int32)
    for i, a in enumerate(elements):
        for j, b in enumerate(elements):
            sub[i, j] = index[tuple((x - y) % p for x, y in zip(a, b))]
    qr = np.zeros(q, dtype=bool)
    for e in elements[1:]:
        qr[index[poly_mul(list(e), list(e), mod)]] = True
    return sub, qr


def _jacobsthal(q: int) -> np.ndarray:
    """Jacobsthal matrix Q[i, j] = chi(x_i - x_j) over GF(q) (chi the
    quadratic character; q any odd prime power)."""
    sub, qr = _gf_tables(q)
    chi = np.where(qr, 1, -1).astype(np.int8)
    out = chi[sub]
    np.fill_diagonal(out, 0)
    return out


def _paley_I(q: int) -> np.ndarray:
    """Hadamard matrix of order q+1 for q = 3 (mod 4): H = I + S with S
    the skew conference matrix built from the Jacobsthal matrix."""
    Q = _jacobsthal(q)
    n = q + 1
    H = np.ones((n, n), dtype=np.int8)
    H[1:, 1:] = Q + np.eye(q, dtype=np.int8)
    H[1:, 0] = -1
    return H


def _paley_II_standard(q: int) -> np.ndarray:
    """Paley II: H = kron(S, [[1,1],[1,-1]]) + kron(I_m, [[1,-1],[-1,-1]])
    for the (m x m) symmetric conference matrix S (zero diagonal)."""
    Q = _jacobsthal(q)
    m = q + 1
    S = np.zeros((m, m), dtype=np.int8)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    H = np.kron(S, np.array([[1, 1], [1, -1]], dtype=np.int8)) + np.kron(
        np.eye(m, dtype=np.int8), np.array([[1, -1], [-1, -1]], dtype=np.int8)
    )
    return H


def _verified(H: np.ndarray) -> np.ndarray:
    """Assert H is genuinely Hadamard (H @ H.T == nI) before returning. The
    product runs in float32 BLAS: every partial sum of +-1 products is an
    integer below 2^24, so it is exact in any summation order."""
    n = H.shape[0]
    Hf = H.astype(np.float32)
    if not np.array_equal(Hf @ Hf.T, n * np.eye(n, dtype=np.float32)):
        raise AssertionError(
            f"constructed matrix of order {n} is not Hadamard"
        )
    return H


def _method(k: int) -> str | None:
    """How ``_base_hadamard`` builds order k (a multiple of 4, not a power
    of 2): Paley I (k = q + 1, q an odd prime power = 3 mod 4), Paley II
    (k = 2(q + 1), q an odd prime power = 1 mod 4), the embedded table of
    classical computer-search orders, or doubling (k = 2 * k2)."""
    from compressed_tensors_tpu_torch.transform.hadamard_data import (
        known_base_orders,
    )

    if _prime_power(k - 1) and (k - 1) % 4 == 3:
        return "paley_I"
    if k % 2 == 0 and _prime_power(k // 2 - 1) and (k // 2 - 1) % 4 == 1:
        return "paley_II"
    if k in known_base_orders():
        return "table"
    return "double" if k % 2 == 0 else None


@lru_cache(maxsize=None)
def _base_hadamard(k: int) -> np.ndarray | None:
    """A Hadamard matrix of order k (not necessarily a power of 2), or
    None, as int8 on the host."""
    if k == 1:
        return np.array([[1]], dtype=np.int8)
    if is_pow2(k):
        return _sylvester(k)
    if k % 4 != 0:
        return None
    method = _method(k)
    if method == "paley_I":
        return _verified(_paley_I(k - 1))
    if method == "paley_II":
        return _verified(_paley_II_standard(k // 2 - 1))
    if method == "table":
        from compressed_tensors_tpu_torch.transform.hadamard_data import (
            known_hadamard,
        )

        return known_hadamard(k)
    half = _base_hadamard(k // 2) if method == "double" else None
    if half is None:
        return None
    return np.kron(np.array([[1, 1], [1, -1]], dtype=np.int8), half)


@lru_cache(maxsize=None)
def _sylvester(size: int) -> np.ndarray:
    log2 = int(math.log2(size))
    H = np.array([[1]], dtype=np.int8)
    for _ in range(log2):
        H = np.block([[H, H], [H, -H]])
    return H


def _base(size: int) -> tuple[int, np.ndarray]:
    """The largest order k with size / k a power of 2 for which a base
    matrix exists, and that matrix."""
    for k in sorted(
        (d for d in range(1, size + 1) if size % d == 0 and
         is_pow2(size // d)),
        reverse=True,
    ):
        base = _base_hadamard(k)
        if base is not None:
            return k, base
    raise ValueError(f"Cannot construct hadamard matrix of size {size}")


def hadamard_construction(size: int) -> str:
    """How ``hadamard_matrix(size)`` is built, e.g. ``"Paley I (q = 3583)
    doubled 2x"`` or ``"Sylvester 4096"`` (builds and caches the host
    base)."""
    if is_pow2(size):
        return f"Sylvester {size}"
    root, doublings = _base(size)[0], 0
    while _method(root) == "double":
        root, doublings = root // 2, doublings + 1
    how = {"paley_I": f"Paley I (q = {root - 1})",
           "paley_II": f"Paley II (q = {root // 2 - 1})",
           "table": f"tabled order {root}"}[_method(root)]
    return how + (f" doubled {doublings}x" if doublings else "")


def _on_device(h: np.ndarray, dtype, device) -> torch.Tensor:
    from compressed_tensors_tpu_torch.models.llama import resolve_device

    return torch.from_numpy(h).to(resolve_device(device)).to(dtype)


def deterministic_hadamard_matrix(size: int, dtype=torch.float64,
                                  device="cuda") -> torch.Tensor:
    """Sylvester construction; size must be a power of 2."""
    if size <= 0:
        raise ValueError("Cannot construct deterministic hadamard of size <= 0")
    log2 = int(math.log2(size))
    if size != 2**log2:
        raise ValueError(
            "Cannot construct deterministic hadamard of size != 2^n"
        )
    return _on_device(_sylvester(size), dtype, device)


def hadamard_matrix(size: int, dtype=torch.float64,
                    device="cuda") -> torch.Tensor:
    """A Hadamard matrix of the given order: Sylvester for powers of 2,
    otherwise kron(base, sylvester) with the base of ``_base``, the
    product formed on ``device`` in int8 (exact: +-1 entries)."""
    if is_pow2(size):
        return _on_device(_sylvester(size), dtype, device)
    k, base = _base(size)
    b = _on_device(base, torch.int8, device)
    s = _on_device(_sylvester(size // k), torch.int8, device)
    return (b[:, None, :, None] * s[None, :, None, :]).reshape(
        size, size).to(dtype)


def random_hadamard_matrix(size: int, seed: int = 0, dtype=torch.float64,
                           device="cuda") -> torch.Tensor:
    """Randomized Hadamard: H @ diag(+-1), the signs from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2, size=size) * 2 - 1
    H = hadamard_matrix(size, dtype=torch.float64, device=device)
    return (H * torch.from_numpy(q).to(H)[None, :]).to(dtype)


def random_matrix(size: int, seed: int = 0, dtype=torch.float64,
                  device="cuda") -> torch.Tensor:
    """Uniform random (invertible with prob. 1) matrix from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return _on_device(rng.random((size, size)), dtype, device)


def high_precision_invert(weight: torch.Tensor) -> torch.Tensor:
    """float64 inverse, on the weight's device, in the weight's dtype."""
    return torch.linalg.inv(weight.to(torch.float64)).to(weight.dtype)
