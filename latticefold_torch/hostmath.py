"""Exact host-side algebra on Python ints.

Used for: the Fiat-Shamir transcript, verifier-side ring arithmetic (tiny),
ring construction (factoring cyclotomics, CRT matrices) and as the oracle for
cross-checking device kernels in tests. Mirrors the scalar semantics of the
reference's `stark-rings` traits (`Ring`, `PolyRing`, `OverField`, `CRT/ICRT`)
reconstructed from use-sites (SURVEY.md §2.6).
"""

from __future__ import annotations

import random
from typing import List, Sequence

# ---------------------------------------------------------------------------
# F_q[t] polynomial helpers (coefficient lists, low to high, trimmed)
# ---------------------------------------------------------------------------


def _ptrim(p: List[int]) -> List[int]:
    while p and p[-1] == 0:
        p.pop()
    return p


def pmul(a: Sequence[int], b: Sequence[int], q: int) -> List[int]:
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % q
    return _ptrim(out)


def pmod(a: Sequence[int], mod: Sequence[int], q: int) -> List[int]:
    a = list(a)
    dm = len(mod) - 1
    inv_lead = pow(mod[-1], q - 2, q)
    while len(a) - 1 >= dm and _ptrim(a):
        if not a:
            break
        c = a[-1] * inv_lead % q
        shift = len(a) - 1 - dm
        for i, mi in enumerate(mod):
            a[shift + i] = (a[shift + i] - c * mi) % q
        _ptrim(a)
    return a


def pmulmod(a, b, mod, q):
    return pmod(pmul(a, b, q), mod, q)


def ppowmod(a, e: int, mod, q) -> List[int]:
    result = [1]
    base = pmod(list(a), mod, q)
    while e:
        if e & 1:
            result = pmulmod(result, base, mod, q)
        base = pmulmod(base, base, mod, q)
        e >>= 1
    return result


def pgcd(a, b, q) -> List[int]:
    a, b = _ptrim(list(a)), _ptrim(list(b))
    while b:
        a, b = b, pmod(a, b, q)
    if a:
        inv = pow(a[-1], q - 2, q)
        a = [c * inv % q for c in a]
    return a


def factor_equal_degree(poly: Sequence[int], e: int, q: int, seed: int = 0xC0FFEE) -> List[List[int]]:
    """Cantor-Zassenhaus equal-degree factorization.

    ``poly`` must be squarefree, monic, with all irreducible factors of degree
    ``e``. Deterministic given ``seed``. Returns factors sorted by coefficient
    tuple (canonical component order anchor).
    """
    rng = random.Random(seed)
    poly = _ptrim(list(poly))
    n = len(poly) - 1
    assert n % e == 0
    work = [poly]
    done: List[List[int]] = []
    while work:
        f = work.pop()
        if len(f) - 1 == e:
            done.append(f)
            continue
        # random split
        while True:
            g = [rng.randrange(q) for _ in range(len(f) - 1)]
            g = _ptrim(g)
            if not g:
                continue
            if q % 2 == 1:
                h = ppowmod(g, (q**e - 1) // 2, f, q)
                h = list(h)
                if h:
                    h[0] = (h[0] - 1) % q
                d = pgcd(f, h, q)
            else:  # pragma: no cover - all our primes are odd
                raise NotImplementedError
            if d and 0 < len(d) - 1 < len(f) - 1:
                quo = pdiv_exact(f, d, q)
                work.append(d)
                work.append(quo)
                break
    done.sort(key=lambda p: tuple(p))
    return done


def pdiv_exact(a, b, q) -> List[int]:
    a = list(a)
    out = [0] * (len(a) - len(b) + 1)
    inv_lead = pow(b[-1], q - 2, q)
    for shift in range(len(a) - len(b), -1, -1):
        c = a[shift + len(b) - 1] * inv_lead % q
        out[shift] = c
        if c:
            for i, bi in enumerate(b):
                a[shift + i] = (a[shift + i] - c * bi) % q
    assert not _ptrim(a), "division was not exact"
    return out


# ---------------------------------------------------------------------------
# Extension field K = F_q[y]/m(y): elements are tuples of e ints
# ---------------------------------------------------------------------------


class ExtField:
    def __init__(self, q: int, modpoly: Sequence[int]):
        self.q = q
        self.m = list(modpoly)  # monic, degree e, low-to-high, length e+1
        self.e = len(modpoly) - 1
        # reduction rows: y^(e+k) mod m for k in [0, e-1)
        red = []
        if self.e > 1:
            cur = [(-c) % q for c in self.m[:-1]]  # y^e
            red.append(list(cur))
            for _ in range(self.e - 2):
                cur = self._shift_reduce(cur)
                red.append(list(cur))
        self.red_rows = red  # red_rows[k] = coords of y^(e+k)

    def _shift_reduce(self, coords):
        q = self.q
        out = [0] + list(coords[:-1])
        top = coords[-1]
        if top:
            for i in range(self.e):
                out[i] = (out[i] + top * ((-self.m[i]) % q)) % q
        return out

    def zero(self):
        return (0,) * self.e

    def one(self):
        return (1,) + (0,) * (self.e - 1)

    def embed(self, c: int):
        return (c % self.q,) + (0,) * (self.e - 1)

    def add(self, a, b):
        q = self.q
        return tuple((x + y) % q for x, y in zip(a, b))

    def sub(self, a, b):
        q = self.q
        return tuple((x - y) % q for x, y in zip(a, b))

    def smul(self, c: int, a):
        q = self.q
        return tuple(c * x % q for x in a)

    def mul(self, a, b):
        q, e = self.q, self.e
        conv = [0] * (2 * e - 1)
        for i in range(e):
            if a[i]:
                for j in range(e):
                    conv[i + j] += a[i] * b[j]
        out = [c % q for c in conv[:e]]
        for k in range(e - 1):
            hi = conv[e + k] % q
            if hi:
                row = self.red_rows[k]
                for i in range(e):
                    out[i] = (out[i] + hi * row[i]) % q
        return tuple(out)

    def pow(self, a, n: int):
        result = self.one()
        base = a
        while n:
            if n & 1:
                result = self.mul(result, base)
            base = self.mul(base, base)
            n >>= 1
        return result

    def inv(self, a):
        # a^(q^e - 2)
        return self.pow(a, self.q**self.e - 2)
