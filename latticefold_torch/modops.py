"""Multi-limb modular arithmetic on 32-bit limbs held in int64 tensors.

Field elements are tensors with a trailing limb axis of static length ``nl``
(little-endian 32-bit limbs), in the Montgomery domain with
``R = 2**(32*nl)`` unless stated otherwise -- the same layout as the JAX
package, so values compare limb for limb.

Why int64 and not uint32: PyTorch's CPU backend has no uint32 ``+`` or
``>>``. An int64 lane holds a 32-bit limb with 31 bits of headroom, so a
limb sum's carry is simply ``s >> 32``; the product of two limbs wraps in
int64 but its low 64 bits -- all a 32x32 -> 64 product has -- are exact, so
``(p >> 32) & MASK`` and ``p & MASK`` give its high and low words. The CIOS
loops are unrolled in Python over the (static) limb count, exactly as in the
JAX package's modops; the carry/borrow formulas are plain shifts because
this backend has no compiler hazard to dodge.

The host half (``Modulus``, ``encode``/``decode``) is a copy of the JAX
package's, kept here so the port imports nothing of it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def _int_to_limbs(x: int, nl: int) -> np.ndarray:
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(nl)], dtype=np.uint32)


@dataclass(frozen=True)
class Modulus:
    """Static constants for a prime modulus q held in ``nl`` uint32 limbs."""

    q: int
    nl: int
    ninv: int = field(init=False)  # -q^{-1} mod 2^32 (Montgomery constant)
    r1: int = field(init=False)  # R mod q (Montgomery representation of 1)
    r2: int = field(init=False)  # R^2 mod q (to_montgomery multiplier)

    def __post_init__(self):
        R = 1 << (32 * self.nl)
        object.__setattr__(self, "ninv", (-pow(self.q, -1, 1 << 32)) % (1 << 32))
        object.__setattr__(self, "r1", R % self.q)
        object.__setattr__(self, "r2", (R * R) % self.q)

    # ---- host-side conversions -------------------------------------------------
    @functools.cached_property
    def q_limbs(self) -> np.ndarray:
        return _int_to_limbs(self.q, self.nl)

    @functools.cached_property
    def r1_limbs(self) -> np.ndarray:
        return _int_to_limbs(self.r1, self.nl)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return _int_to_limbs(self.r2, self.nl)

    def encode(self, arr) -> np.ndarray:
        """Python ints / int array -> canonical-domain limb array [..., nl]
        (the limbs taken from the whole array a word at a time)."""
        a = np.asarray(arr, dtype=object)
        flat = np.array([int(v) % self.q for v in a.reshape(-1)], dtype=object)
        out = np.empty((flat.shape[0], self.nl), dtype=np.uint32)
        for i in range(self.nl):
            out[:, i] = (flat >> (32 * i)) & 0xFFFFFFFF
        return out.reshape(a.shape + (self.nl,))

    def decode(self, limbs) -> np.ndarray:
        """Canonical-domain limb array [..., nl] -> object array of Python ints."""
        a = np.asarray(limbs)
        out = np.empty(a.shape[:-1], dtype=object)
        oflat = out.reshape(-1)
        aflat = a.reshape(-1, self.nl)
        for i in range(aflat.shape[0]):
            v = 0
            for j in range(self.nl - 1, -1, -1):
                v = (v << 32) | int(aflat[i, j])
            oflat[i] = v
        return out


def _ints(limbs: np.ndarray) -> list:
    return [int(v) for v in limbs]


# ---------------------------------------------------------------------------
# limb-list helpers. A limb is an int64 tensor of values in [0, 2^32) or a
# Python int (constants broadcast for free).
# ---------------------------------------------------------------------------


def _unpack(x, nl):
    return [x[..., i] for i in range(nl)]


def _pack(limbs):
    return torch.stack(torch.broadcast_tensors(*limbs), dim=-1)


def _add_limbs(a, b, nl):
    """a + b with carry-out (0/1)."""
    out = []
    carry = 0
    for i in range(nl):
        s = a[i] + b[i] + carry
        out.append(s & MASK32)
        carry = s >> 32
    return out, carry


def _sub_limbs(a, b, nl):
    """a - b (mod 2^(32 nl)) with borrow-out (0/1)."""
    out = []
    borrow = 0
    for i in range(nl):
        d = a[i] - b[i] - borrow
        out.append(d & MASK32)
        borrow = (d >> 32) & 1
    return out, borrow


def _geq(a, b, nl):
    """0/1: a >= b over little-endian limbs."""
    _, borrow = _sub_limbs(a, b, nl)
    return 1 - borrow


def _select(cond, a, b):
    """Limbwise ``a`` where cond (0/1 tensor) else ``b``."""
    c = cond.bool()
    return [torch.where(c, x, y) for x, y in zip(a, b)]


def _reduce_once(m: Modulus, s, over):
    """s + over*2^(32 nl), known < 2q -> canonical (subtract q at most once)."""
    q = _ints(m.q_limbs)
    red, borrow = _sub_limbs(s, q, m.nl)
    return _select(over | (1 - borrow), red, s)


# ---------------------------------------------------------------------------
# Public modular ops. Arguments/results: int64 tensors [..., nl].
# ---------------------------------------------------------------------------


def add(m: Modulus, a, b):
    s, carry = _add_limbs(_unpack(a, m.nl), _unpack(b, m.nl), m.nl)
    return _pack(_reduce_once(m, s, carry))


def sub(m: Modulus, a, b):
    nl = m.nl
    d, borrow = _sub_limbs(_unpack(a, nl), _unpack(b, nl), nl)
    fixed, _ = _add_limbs(d, _ints(m.q_limbs), nl)
    return _pack(_select(borrow, fixed, d))


def neg(m: Modulus, a):
    return sub(m, torch.zeros_like(a), a)


def _mont_limbs(m: Modulus, al, bl):
    """CIOS Montgomery product of limb lists: a*b*R^{-1} mod q, canonical."""
    nl = m.nl
    q = _ints(m.q_limbs)
    ninv = m.ninv
    t = [0] * (nl + 2)
    for i in range(nl):
        c = 0
        for j in range(nl):
            # true value <= (2^32-1)^2 + 2(2^32-1) = 2^64-1: int64 keeps its bits
            p = al[i] * bl[j] + t[j] + c
            t[j] = p & MASK32
            c = (p >> 32) & MASK32
        s = t[nl] + c
        t[nl] = s & MASK32
        t[nl + 1] = t[nl + 1] + (s >> 32)
        mu = (t[0] * ninv) & MASK32
        p = mu * q[0] + t[0]
        c = (p >> 32) & MASK32
        for j in range(1, nl):
            p = mu * q[j] + t[j] + c
            t[j - 1] = p & MASK32
            c = (p >> 32) & MASK32
        s = t[nl] + c
        t[nl - 1] = s & MASK32
        t[nl] = t[nl + 1] + (s >> 32)
        t[nl + 1] = 0
    return _reduce_once(m, t[:nl], t[nl])


def mont_mul(m: Modulus, a, b):
    """a*b*R^{-1} mod q for a, b [..., nl] (broadcastable)."""
    return _pack(_mont_limbs(m, _unpack(a, m.nl), _unpack(b, m.nl)))


def mul_const(m: Modulus, a, c: int):
    """mont_mul by the constant ``c`` (an int < q), broadcast as Python-int
    limbs: no device tensor is made for it."""
    return _pack(_mont_limbs(m, _unpack(a, m.nl), _ints(_int_to_limbs(c, m.nl))))


def to_mont(m: Modulus, a):
    return mul_const(m, a, m.r2)


def from_mont(m: Modulus, a):
    return mul_const(m, a, 1)


def sum_mod(m: Modulus, a, axis: int):
    """Tree-reduction modular sum along ``axis`` (not the limb axis)."""
    if axis < 0:
        axis += a.ndim
    n = a.shape[axis]
    while n > 1:
        half = n // 2
        s = add(m, a.narrow(axis, 0, half), a.narrow(axis, half, half))
        if n % 2:
            s = torch.cat([s, a.narrow(axis, 2 * half, 1)], dim=axis)
        a = s
        n = a.shape[axis]
    return a.squeeze(axis)


# ---------------------------------------------------------------------------
# Balanced digit decomposition: balanced base-b digits with
# round-half-toward-zero, so |digit| <= b/2 and recomposition is exact.
# ---------------------------------------------------------------------------


def _divmod_small(x, b: int, nl: int):
    """Long division of limb list ``x`` by a constant ``b < 2**31``, high limb
    first; every intermediate (rem * 2^32 + limb) fits in int64."""
    rem = torch.zeros_like(x[0])
    qs = [None] * nl
    for i in range(nl - 1, -1, -1):
        acc = (rem << 32) | x[i]
        qs[i] = torch.div(acc, b, rounding_mode="floor")
        rem = acc - qs[i] * b
    return qs, rem


def signed_digits(m: Modulus, a, b: int, ndigits: int):
    """Balanced base-b digits of the signed representative of ``a``.

    ``a``: canonical-domain limbs [..., nl]. Returns int64 [..., ndigits] with
    digits in [-b/2, b/2] (half rounds toward zero), such that
    sum(d_i * b^i) == signed(a) exactly, provided b^ndigits covers q/2.
    """
    nl = m.nl
    al = _unpack(a, nl)
    q = _ints(m.q_limbs)
    qh = _ints(_int_to_limbs(m.q // 2, nl))
    negative = 1 - _geq(qh, al, nl)  # a > q/2 => negative representative
    qa, _ = _sub_limbs(q, al, nl)
    mag = _select(negative, qa, al)
    sign = 1 - 2 * negative
    half = b // 2
    digs = []
    for _ in range(ndigits):
        quo, rem = _divmod_small(mag, b, nl)
        carry = (rem > half).long()  # half toward zero: keep rem iff 2 rem <= b
        digs.append(rem - b * carry)
        mag, _ = _add_limbs(quo, [carry] + [0] * (nl - 1), nl)
    return torch.stack(digs, dim=-1) * sign[..., None]


def digits_to_field(m: Modulus, d):
    """Small signed integer digits [...] -> canonical-domain limbs [..., nl]."""
    nl = m.nl
    mag = d.abs().long()
    zero = torch.zeros_like(mag)
    pos = [mag] + [zero] * (nl - 1)
    negv, _ = _sub_limbs(_ints(m.q_limbs), pos, nl)
    return _pack(_select(d < 0, negv, pos))
