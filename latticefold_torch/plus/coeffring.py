"""Coefficient-form ring helpers for LatticeFold+ (host code).

A copy of the JAX package's module of the same name, kept here so the port
imports nothing of it. The reference latticefold-plus crate works over the
*coefficient* representation (``CoeffRing``/``RqPoly``, plus.rs:15-17).
Bulk data stays in NTT form (the same tensor layout as the LatticeFold
side) and crosses to coefficient form only where the protocol semantics
demand it: transcript
absorption (coefficients, transcript.rs:33-40 of the plus crate), monomial
EXP/ct/psi algebra (rgchk.rs:193-241), and the ``ev`` polynomial evaluation
used by the monomial set check (setchk.rs:46-57).

Monomial convention (matches the LatticeFold+ paper's EXP map, eprint
2025/247, and the use sites of stark-rings' ``exp``/``psi`` in rgchk.rs):
``EXP(a) = X^(a mod d)`` for signed exponents a in (-d', d'], d' = d/2 —
always a POSITIVE monomial (negative digits land at exponents in (d', d)).
Positivity is forced by the set check's ev-projection: ev(m, beta)^2 ==
ev(m, beta^2) holds exactly for entries with a single +1 coefficient
(setchk.rs:108 pairs the pointwise square against ev at beta^2 in the
verifier, setchk.rs:310-312). ``psi`` is the unique element with
ct(psi * EXP(a)) = a on (-d', d']: psi_0 = 0, psi_j = j for 0 < j < d',
psi_j = j - d for d' <= j < d — verified by an exhaustive unit test.

Only power-of-two cyclotomics (X^d + 1: stark/frog shapes) support the
monomial algebra; the trinomial rings would need a different EXP set. The
reference has the same restriction de facto (all plus tests use frog).
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..rings.construct import Ring


def require_power2(ring: Ring):
    if ring.n_cyc != 2 * ring.d:
        raise ValueError(
            f"LatticeFold+ monomial algebra needs X^d+1 (power-of-two cyclotomic); "
            f"ring {ring.name} has conductor {ring.n_cyc}, degree {ring.d}"
        )


# ---------------------------------------------------------------------------
# host coefficient-form scalar algebra (verifier side; values = lists of ints)
# ---------------------------------------------------------------------------


def czero(ring: Ring) -> List[int]:
    return [0] * ring.d


def cone(ring: Ring) -> List[int]:
    return [1] + [0] * (ring.d - 1)


def cconst(ring: Ring, v: int) -> List[int]:
    return [v % ring.q] + [0] * (ring.d - 1)


def cadd(ring: Ring, a, b) -> List[int]:
    q = ring.q
    return [(x + y) % q for x, y in zip(a, b)]


def csub(ring: Ring, a, b) -> List[int]:
    q = ring.q
    return [(x - y) % q for x, y in zip(a, b)]


def cscale(ring: Ring, s: int, a) -> List[int]:
    q = ring.q
    return [s * x % q for x in a]


def cmul(ring: Ring, a, b) -> List[int]:
    """Negacyclic (X^d+1) coefficient-form product (host, d <= 72)."""
    q, d = ring.q, ring.d
    out = [0] * d
    for i, ai in enumerate(a):
        if not ai:
            continue
        for j, bj in enumerate(b):
            if not bj:
                continue
            k = i + j
            if k < d:
                out[k] = (out[k] + ai * bj) % q
            else:
                out[k - d] = (out[k - d] - ai * bj) % q
    return out


def csum(ring: Ring, elts) -> List[int]:
    acc = czero(ring)
    for e in elts:
        acc = cadd(ring, acc, e)
    return acc


def ct(a) -> int:
    """Constant-term extraction (stark-rings ``.ct()``; rgchk.rs:202,225)."""
    return a[0]


def ev(ring: Ring, a, x: int) -> int:
    """Polynomial evaluation sum_i a_i x^i over F_q (setchk.rs:46-57)."""
    q = ring.q
    acc = 0
    for c in reversed(a):
        acc = (acc * x + c) % q
    return acc


@functools.lru_cache(maxsize=None)
def psi_coeffs(ring: Ring) -> tuple:
    """psi: ct(psi * EXP(a)) == a for a in (-d', d']."""
    require_power2(ring)
    d, dp, q = ring.d, ring.d // 2, ring.q
    out = [0] * d
    for j in range(1, dp):
        out[j] = j
    for j in range(dp, d):
        out[j] = (j - d) % q
    return tuple(out)


def exp_idx(ring: Ring, a: int) -> int:
    """EXP exponent index: a mod d (signed digit -> monomial X^idx)."""
    return a % ring.d


def exp_coeffs(ring: Ring, a: int) -> List[int]:
    """EXP(a) as a coefficient vector (positive monomial X^(a mod d))."""
    require_power2(ring)
    out = [0] * ring.d
    out[a % ring.d] = 1
    return out


def mono_ev(ring: Ring, m: int, x: int) -> int:
    """ev(X^m, x) = x^m for monomial index m in [0, d)."""
    return pow(x, m, ring.q)


# ---------------------------------------------------------------------------
# tensor tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def monomial_table_np(ring: Ring) -> np.ndarray:
    """NTT forms (Montgomery limbs) of the d monomials X^m, [d, ncomp, e, nl].

    monomial_table[m] = CRT(X^m). Gathering by EXP index (digit mod d) turns
    stark-rings' ``exp`` (rgchk.rs:292) into a tensor gather.
    """
    require_power2(ring)
    R = 1 << (32 * ring.nl)
    rows = np.empty((ring.d, ring.ncomp, ring.e), dtype=object)
    for m in range(ring.d):
        ntt = ring.crt_host(exp_coeffs(ring, m))
        for c in range(ring.ncomp):
            for t in range(ring.e):
                rows[m, c, t] = ntt[c][t] * R % ring.q
    return ring.fq.encode(rows)


@functools.lru_cache(maxsize=None)
def monomial_table(ring: Ring, device: torch.device) -> torch.Tensor:
    """``monomial_table_np`` as an int64 tensor on ``device``."""
    return torch.from_numpy(monomial_table_np(ring).astype(np.int64)).to(device)
