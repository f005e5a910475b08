"""Constraint systems: CCS / R1CS structures and instance types.

Ports the semantics of crates/latticefold/src/arith.rs
(CCS 51-171, CCCS 180-185, LCCCS 193-206, Instance 394-421) and
arith/r1cs.rs (R1CS 16-63, test fixtures 128-306). Matrices live as device
SpMV operators (arith/sparse.py); instance data (commitments, statements,
evaluation claims) are small host ring elements.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from ..rings.construct import Ring
from .sparse import SparseMatrix


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


@dataclass
class R1CS:
    l: int
    A: SparseMatrix
    B: SparseMatrix
    C: SparseMatrix

    def check_relation(self, ring: Ring, z_host: list) -> bool:
        Az = self.A.mat_vec_host(z_host)
        Bz = self.B.mat_vec_host(z_host)
        Cz = self.C.mat_vec_host(z_host)
        return all(
            ring.rmul(a, b) == c for a, b, c in zip(Az, Bz, Cz)
        )

    def relax(self) -> "RelaxedR1CS":
        """Nova-style relaxation with u = 1, E = 0 (r1cs.rs:43-54)."""
        return RelaxedR1CS(
            l=self.l,
            A=self.A,
            B=self.B,
            C=self.C,
            u=None,  # None encodes ring.one() without needing the ring here
            E=None,  # None encodes the all-zero error vector
        )


@dataclass
class RelaxedR1CS:
    """Relaxed R1CS (Nova, eprint 2021/370 p.14): Az o Bz = u*(Cz) + E
    (r1cs.rs:71-101).

    ``u`` is a ring element (None = one); ``E`` a host list of m ring
    elements (None = zeros)."""

    l: int
    A: SparseMatrix
    B: SparseMatrix
    C: SparseMatrix
    u: object = None
    E: list = None

    def check_relation(self, ring: Ring, z_host: list) -> bool:
        Az = self.A.mat_vec_host(z_host)
        Bz = self.B.mat_vec_host(z_host)
        Cz = self.C.mat_vec_host(z_host)
        u = ring.one() if self.u is None else self.u
        E = [ring.zero()] * len(Cz) if self.E is None else self.E
        return all(
            ring.rmul(a, b) == ring.radd(ring.rmul(u, c), e)
            for a, b, c, e in zip(Az, Bz, Cz, E)
        )


@dataclass
class CCS:
    """m rows, n = |z| cols, l public inputs, t matrices, q multisets, max
    degree d, s = log2 m, s_prime = log2 n."""

    ring: Ring
    m: int
    n: int
    l: int
    t: int
    q: int
    d: int
    s: int
    s_prime: int
    M: List[SparseMatrix]
    S: List[List[int]]
    c: List[int]  # +-1 coefficients (ints; embedded diagonally)

    @classmethod
    def from_r1cs(cls, ring: Ring, r1cs: R1CS, W: int) -> "CCS":
        m = W
        n = r1cs.A.ncols
        return cls(
            ring=ring,
            m=m,
            n=n,
            l=r1cs.l,
            t=3,
            q=2,
            d=2,
            s=int(math.log2(m)),
            s_prime=max(1, (n - 1).bit_length()),
            M=[r1cs.A, r1cs.B, r1cs.C],
            S=[[0, 1], [2]],
            c=[1, -1],
        )

    @classmethod
    def from_r1cs_padded(cls, ring: Ring, r1cs: R1CS, W: int, L: int) -> "CCS":
        ccs = cls.from_r1cs(ring, r1cs, W)
        size = _next_pow2(max((ccs.n - ccs.l - 1) * L, ccs.m))
        ccs.pad_rows_to(size)
        return ccs

    def pad_rows_to(self, size: int):
        size = _next_pow2(size)
        if size > self.m:
            self.m = size
            self.s = int(math.log2(size))
            for mat in self.M:
                mat.pad_rows(size)

    def sanity_check(self, L: int):
        """CCS padding invariant (nifs.rs:165-173)."""
        if self.m != _next_pow2(max((self.n - self.l - 1) * L, self.m)):
            raise ValueError(f"CCS not padded for L={L}: m={self.m} n={self.n} l={self.l}")

    def check_relation_host(self, z_host: list) -> bool:
        """Testing helper (arith.rs:76-105)."""
        ring = self.ring
        result = [ring.zero()] * self.m
        for i in range(self.q):
            had = [ring.one()] * self.m
            for j in self.S[i]:
                Mz = self.M[j].mat_vec_host(z_host)
                Mz = Mz + [ring.zero()] * (self.m - len(Mz))
                had = [ring.rmul(h, v) for h, v in zip(had, Mz)]
            ci = ring.embed_int(self.c[i])
            result = [ring.radd(r, ring.rmul(ci, h)) for r, h in zip(result, had)]
        return all(r == ring.zero() for r in result)


@dataclass
class Commitment:
    """Ajtai commitment: kappa host ring elements with homomorphic ops
    (commitment/homomorphic_commitment.rs:12-83)."""

    ring: Ring
    vals: List[tuple]

    def __add__(self, other):
        return Commitment(self.ring, [self.ring.radd(a, b) for a, b in zip(self.vals, other.vals)])

    def __sub__(self, other):
        return Commitment(self.ring, [self.ring.rsub(a, b) for a, b in zip(self.vals, other.vals)])

    def mul_ring(self, r_elt):
        return Commitment(self.ring, [self.ring.rmul(v, r_elt) for v in self.vals])

    def __eq__(self, other):
        return isinstance(other, Commitment) and self.vals == other.vals

    @classmethod
    def zeroed(cls, ring: Ring, kappa: int):
        return cls(ring, [ring.zero()] * kappa)


@dataclass
class CCCS:
    """Committed CCS instance: (cm, x_ccs) (arith.rs:180-185)."""

    cm: Commitment
    x_ccs: List[tuple]

    def get_z_host(self, ring: Ring, w_host: list) -> list:
        return list(self.x_ccs) + [ring.one()] + list(w_host)


@dataclass
class LCCCS:
    """Linearized CCS instance (arith.rs:193-206): sumcheck point r,
    f-hat evaluation claims v, commitment, Mz claims u, statement x_w, h."""

    r: List[tuple]  # K elements
    v: List[tuple]  # ring elements (tau of them)
    cm: Commitment
    u: List[tuple]  # ring elements (t of them)
    x_w: List[tuple]
    h: tuple

    def get_z_host(self, ring: Ring, w_host: list) -> list:
        return list(self.x_w) + [self.h] + list(w_host)


# ---------------------------------------------------------------------------
# fixtures (ports of arith/r1cs.rs:128-235 and arith/ccs.rs generators)
# ---------------------------------------------------------------------------


def get_test_r1cs(ring: Ring) -> R1CS:
    """Vitalik's x^3 + x + 5 = y example (r1cs.rs:128-151)."""
    A = SparseMatrix.from_dense(ring, [
        [1, 0, 0, 0, 0, 0],
        [0, 0, 0, 1, 0, 0],
        [1, 0, 0, 0, 1, 0],
        [0, 5, 0, 0, 0, 1],
    ])
    B = SparseMatrix.from_dense(ring, [
        [1, 0, 0, 0, 0, 0],
        [1, 0, 0, 0, 0, 0],
        [0, 1, 0, 0, 0, 0],
        [0, 1, 0, 0, 0, 0],
    ])
    C = SparseMatrix.from_dense(ring, [
        [0, 0, 0, 1, 0, 0],
        [0, 0, 0, 0, 1, 0],
        [0, 0, 0, 0, 0, 1],
        [0, 0, 1, 0, 0, 0],
    ])
    return R1CS(l=1, A=A, B=B, C=C)


def get_test_z(ring: Ring, inp: int) -> list:
    """z = (io, 1, w) for the fixture (r1cs.rs:225-235)."""
    vals = [inp, 1, inp**3 + inp + 5, inp**2, inp**3, inp**3 + inp]
    return [ring.embed_int(v) for v in vals]


def get_test_z_split(ring: Ring, inp: int):
    z = get_test_z(ring, inp)
    return z[1], [z[0]], z[2:]


def get_test_dummy_r1cs(ring: Ring, x_len: int, wit_len: int, rows: int) -> R1CS:
    """Identity A=B=C of arbitrary size (r1cs.rs:155-166): z of all ones."""
    ncols = x_len + wit_len + 1
    ident = [[(1, i)] for i in range(rows)]
    A = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    B = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    C = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    return R1CS(l=x_len, A=A, B=B, C=C)


def get_test_dummy_r1cs_non_scalar(ring: Ring, x_len: int, wit_len: int, rows: int, witness: list) -> R1CS:
    """A=B=identity, C = diag(witness) so that Az o Bz = Cz for z = witness-ish
    (r1cs.rs:170-223)."""
    ncols = x_len + wit_len + 1
    ident = [[(1, i)] for i in range(rows)]
    A = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    B = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    C = SparseMatrix(ring, rows, ncols, [[(witness[i], i)] for i in range(rows)])
    return R1CS(l=x_len, A=A, B=B, C=C)


def get_test_dummy_degree_three_ccs_non_scalar(
    ring: Ring, witness: list, x_len: int, wit_len: int, L: int
) -> CCS:
    """Degree-3 CCS of arbitrary size (ccs.rs:14-43): A=B=C=identity,
    D = diag(w_i^2) so that (Az)(Bz)(Cz) = Dz for z built from the witness;
    S = [[0,1,2],[3]], c = [1, -1]."""
    ncols = x_len + wit_len + 1
    rows = len(witness)
    ident = [[(1, i)] for i in range(rows)]
    A = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    B = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    C = SparseMatrix(ring, rows, ncols, [list(r) for r in ident])
    D = SparseMatrix(
        ring, rows, ncols,
        [[(ring.rmul(witness[i], witness[i]), i)] for i in range(rows)],
    )
    m = rows
    ccs = CCS(
        ring=ring, m=m, n=ncols, l=1, t=4, q=2, d=3,
        s=max(1, (m - 1).bit_length()), s_prime=max(1, (ncols - 1).bit_length()),
        M=[A, B, C, D], S=[[0, 1, 2], [3]], c=[1, -1],
    )
    size = _next_pow2(max((ccs.n - ccs.l - 1) * L, ccs.m))
    ccs.pad_rows_to(size)
    return ccs


def get_test_dummy_z_split_ntt(ring: Ring, x_len: int, wit_len: int):
    """(one, ones statement, ramp witness) (r1cs.rs:289-306)."""
    one = ring.one()
    statement = [ring.one()] * x_len
    wit_elt = tuple(ring.K.embed(i) for i in range(ring.ncomp))
    witness = [wit_elt] * wit_len
    return one, statement, witness
