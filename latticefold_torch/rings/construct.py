"""Cyclotomic ring construction: CRT bases, matrices, and the four presets.

Design (ARCHITECTURE.md §1): a ring ``R = F_q[X]/Φ_n(X)`` of degree
``d = φ(n)`` splits into ``ncomp = d/e`` copies of ``K = F_{q^e}``,
``e = ord(q mod n)``. We choose a canonical irreducible factor ``m(y)`` of
Φ_n over F_q (Cantor-Zassenhaus with fixed seed, smallest factor in the
coefficient order), set ``K = F_q[y]/m(y)`` with ``ζ = y`` a primitive n-th
root of unity, and define CRT component ``c`` as evaluation at ``ζ^{j_c}``
where ``j_0 < j_1 < ...`` are the minimal Frobenius-orbit representatives of
``(Z/n)*``. CRT/ICRT are then plain d×d F_q matrices.

Matches the component *shapes* of the reference rings
(crates/cyclotomic-rings/src/rings/{goldilocks,babybear,stark,frog}.rs):
Goldilocks 8×F_{q^3}, BabyBear 8×F_{q^9}, Stark 16×F_q, Frog 4×F_{q^4}.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ..hostmath import ExtField, factor_equal_degree
from ..modops import Modulus


def _phi_trinomial(d: int, q: int) -> List[int]:
    """X^d - X^(d/2) + 1 (Φ_{3·d/2·2}-style trinomial cyclotomic)."""
    phi = [0] * (d + 1)
    phi[0] = 1
    phi[d // 2] = (-1) % q
    phi[d] = 1
    return phi


def _phi_power2(d: int, q: int) -> List[int]:
    """X^d + 1 (Φ_{2d} for d a power of two)."""
    phi = [0] * (d + 1)
    phi[0] = 1
    phi[d] = 1
    return phi


def _matinv_mod(M: List[List[int]], q: int) -> List[List[int]]:
    n = len(M)
    A = [row[:] + [1 if i == j else 0 for j in range(n)] for i, row in enumerate(M)]
    for col in range(n):
        piv = next(r for r in range(col, n) if A[r][col] % q != 0)
        A[col], A[piv] = A[piv], A[col]
        inv = pow(A[col][col], q - 2, q)
        A[col] = [x * inv % q for x in A[col]]
        for r in range(n):
            if r != col and A[r][col]:
                f = A[r][col]
                A[r] = [(x - f * y) % q for x, y in zip(A[r], A[col])]
    return [row[n:] for row in A]


@dataclass(eq=False)  # identity hash: Ring objects are interned via get_ring()
class Ring:
    name: str
    q: int
    n_cyc: int  # conductor n: Φ_n is the ring modulus
    d: int  # φ(n), polynomial degree
    nl: int  # uint32 limbs per F_q element
    e: int = field(init=False)  # extension degree of K
    ncomp: int = field(init=False)  # number of CRT components
    tau: int = field(init=False)  # = e = d / ncomp  (f-hat row count)

    def __post_init__(self):
        q, n = self.q, self.n_cyc
        assert q % 2 == 1
        # e = multiplicative order of q mod n
        e, acc = 1, q % n
        while acc != 1:
            acc = acc * q % n
            e += 1
        self.e = e
        assert self.d % e == 0
        self.ncomp = self.d // e
        self.tau = e
        self.fq = Modulus(q, self.nl)
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        q, d, n, e = self.q, self.d, self.n_cyc, self.e
        if n == 2 * d:  # power-of-two cyclotomic X^d + 1
            self.phi = _phi_power2(d, q)
        else:  # trinomial X^d - X^{d/2} + 1, n = 3*d
            assert n == 3 * d
            self.phi = _phi_trinomial(d, q)

        factors = factor_equal_degree(self.phi, e, q)
        assert len(factors) == self.ncomp
        m0 = factors[0]
        self.K = ExtField(q, m0)
        K = self.K

        # Frobenius orbit representatives of (Z/n)*, ascending
        units = [j for j in range(1, n) if _gcd(j, n) == 1]
        seen = set()
        reps = []
        for j in units:
            if j in seen:
                continue
            orb = set()
            cur = j
            while cur not in orb:
                orb.add(cur)
                cur = cur * (q % n) % n
            seen |= orb
            reps.append(min(orb))
        reps.sort()
        assert len(reps) == self.ncomp
        self.orbit_reps = reps

        # zeta^k table for k in [0, n)
        zeta = (0, 1) + (0,) * (e - 2) if e >= 2 else K.embed(
            (-m0[0]) % q  # root of linear factor y + m0[0]
        )
        if e == 1:
            zpow = [K.one()]
            for _ in range(n - 1):
                zpow.append(K.mul(zpow[-1], zeta))
        else:
            zpow = [K.one()]
            for _ in range(n - 1):
                zpow.append(K.mul(zpow[-1], zeta))
        # sanity: zeta has order exactly n
        assert K.mul(zpow[-1], zeta) == K.one()
        for p in _prime_factors(n):
            assert zpow[n // p] != K.one()

        # CRT matrix: flat row (c*e + t) , col k  ->  coord_t(zeta^{j_c * k})
        crt = [[0] * d for _ in range(d)]
        for c, j in enumerate(reps):
            for k in range(d):
                val = zpow[j * k % n]
                for t in range(e):
                    crt[c * e + t][k] = val[t]
        self.crt_rows = crt
        self.icrt_rows = _matinv_mod(crt, q)

        # multiply-by-X matrix on coefficient vectors (companion of phi)
        rot = [[0] * d for _ in range(d)]
        for k in range(d - 1):
            rot[k + 1][k] = 1
        for i in range(d):
            rot[i][d - 1] = (-self.phi[i]) % q
        self.rotx_rows = rot

        self._np_cache: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    # numpy (host) matrices, canonical domain and Montgomery domain
    # ------------------------------------------------------------------
    def np_matrix(self, which: str, mont: bool = True) -> np.ndarray:
        key = f"{which}:{mont}"
        if key not in self._np_cache:
            rows = {"crt": self.crt_rows, "icrt": self.icrt_rows, "rotx": self.rotx_rows}[which]
            R = 1 << (32 * self.nl)
            vals = [
                [(v * R % self.q) if mont else v for v in row] for row in rows
            ]
            self._np_cache[key] = self.fq.encode(np.array(vals, dtype=object))
        return self._np_cache[key]

    # ------------------------------------------------------------------
    # host scalar ring ops (NTT form = tuple of ncomp K-elements)
    # ------------------------------------------------------------------
    def zero(self):
        return (self.K.zero(),) * self.ncomp

    def one(self):
        return (self.K.one(),) * self.ncomp

    def embed_int(self, v: int):
        return (self.K.embed(v),) * self.ncomp

    def embed_k(self, kelt):
        """Diagonal embedding of a K element (transcript challenges)."""
        return (tuple(kelt),) * self.ncomp

    def radd(self, a, b):
        return tuple(self.K.add(x, y) for x, y in zip(a, b))

    def rsub(self, a, b):
        return tuple(self.K.sub(x, y) for x, y in zip(a, b))

    def rmul(self, a, b):
        return tuple(self.K.mul(x, y) for x, y in zip(a, b))

    def rneg(self, a):
        return tuple(self.K.sub(self.K.zero(), x) for x in a)

    def rsum(self, elts):
        acc = self.zero()
        for x in elts:
            acc = self.radd(acc, x)
        return acc

    def flatten(self, a) -> List[int]:
        """NTT form -> d base-field ints, component-major (absorb order)."""
        return [t for comp in a for t in comp]

    def unflatten(self, vals):
        e = self.e
        return tuple(tuple(vals[c * e : (c + 1) * e]) for c in range(self.ncomp))

    def crt_host(self, coeffs):
        """coefficient vector (d ints) -> NTT form, via the CRT matrix."""
        q = self.q
        flat = [
            sum(r * c for r, c in zip(row, coeffs)) % q for row in self.crt_rows
        ]
        return self.unflatten(flat)

    def icrt_host(self, a):
        q = self.q
        flat = self.flatten(a)
        return [sum(r * c for r, c in zip(row, flat)) % q for row in self.icrt_rows]

    def mul_by_x(self, coeffs):
        """X * f on coefficient vectors (for RotSum; rotation.rs:45-60)."""
        q, d = self.q, self.d
        top = coeffs[d - 1]
        out = [0] + list(coeffs[: d - 1])
        if top:
            for i in range(d):
                out[i] = (out[i] - top * self.phi[i]) % q
        else:
            out = [c % q for c in out]
        return out


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


def _prime_factors(n):
    out, p = [], 2
    while p * p <= n:
        if n % p == 0:
            out.append(p)
            while n % p == 0:
                n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


# ---------------------------------------------------------------------------
# presets (shapes match cyclotomic-rings/src/rings/*.rs; see module docstring)
# ---------------------------------------------------------------------------

GOLDILOCKS_Q = (1 << 64) - (1 << 32) + 1
BABYBEAR_Q = 15 * (1 << 27) + 1
STARK_Q = (1 << 251) + 17 * (1 << 192) + 1
FROG_Q = 15912092521325583641


@functools.lru_cache(maxsize=None)
def get_ring(name: str) -> Ring:
    name = name.lower()
    if name == "goldilocks":
        r = Ring("goldilocks", GOLDILOCKS_Q, 72, 24, 2)
        assert (r.ncomp, r.e) == (8, 3)
    elif name == "babybear":
        r = Ring("babybear", BABYBEAR_Q, 216, 72, 1)
        assert (r.ncomp, r.e) == (8, 9)
    elif name == "stark":
        r = Ring("stark", STARK_Q, 32, 16, 8)
        assert (r.ncomp, r.e) == (16, 1)
    elif name == "frog":
        r = Ring("frog", FROG_Q, 32, 16, 2)
        assert (r.ncomp, r.e) == (4, 4)
    else:
        raise ValueError(f"unknown ring {name}")
    return r
