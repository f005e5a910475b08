"""Committed R1CS frontend for LatticeFold+.

Port of the reference's r1cs.rs: ``ComR1CS.new`` gadget-decomposes z into f
(m*k rows, zero rows up to the scheme's width n), commits cm_f = A f
(r1cs.rs:48-59); ``linearize`` runs a degree-3
sumcheck of eq(r,x)(ga gb - gc) over the mle[Az/Bz/Cz] tables
(r1cs.rs:71-131) and emits the f/ga/gb/gc openings; the verifier
recomputes e (va vb - vc) = s (r1cs.rs:135-161).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from .. import modops as mo
from ..arith.sparse import SparseMatrix
from ..commitment import AjtaiScheme
from ..rings import ops as rops
from ..rings.construct import Ring
from . import coeffring as cr
from . import mleops
from . import sumcheck as psc
from .mlin import LinB, LinBX
from .rgchk import scalar_to_ring_table
from .transcript import PlusTranscript


def gadget_decompose_vec(ring: Ring, z: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """[m, ncomp, e, nl] -> [m*k, ...]: element i digit j at row i*k + j
    (stark-rings GadgetDecompose flattening order)."""
    coeff = mo.from_mont(ring.fq, rops.icrt(ring, z))
    digs = mo.signed_digits(ring.fq, coeff, b, k)  # [m, d, k]
    fc = mo.digits_to_field(ring.fq, digs)  # [m, d, k, nl]
    fc = fc.movedim(2, 1).reshape(z.shape[0] * k, ring.d, ring.nl)
    return rops.crt(ring, mo.to_mont(ring.fq, fc))


def gadget_decompose_matrix(m: SparseMatrix, b: int, k: int) -> SparseMatrix:
    """Column-wise gadget decomposition of a scalar sparse matrix
    (stark-rings SparseMatrix::gadget_decompose as used in r1cs.rs:172-185):
    M'[i, j*k + t] = M[i, j] * b^t."""
    ring = m.ring
    q = ring.q
    rows = []
    for row in m.rows:
        nr = []
        for c, j in row:
            for t in range(k):
                nr.append((c * pow(b, t, q) % q, j * k + t))
        rows.append(nr)
    return SparseMatrix(ring, m.nrows, m.ncols * k, rows)


def r1cs_decomposed_square(ring: Ring, A, B, C, n: int, b: int, k: int):
    """r1cs.rs:172-185: decompose A, B, C columns and pad rows to n."""
    out = []
    for M in (A, B, C):
        Md = gadget_decompose_matrix(M, b, k)
        Md.pad_rows(n)
        out.append(Md)
    return tuple(out)


@dataclass
class ComR1CSX:
    """r1cs.rs:28-35."""

    matrices: List[SparseMatrix]  # [A, B, C]
    z: torch.Tensor
    cm_f: List[list]
    l_in: int


@dataclass
class ComR1CS:
    x: ComR1CSX
    f: torch.Tensor  # [n, ncomp, e, nl]

    @classmethod
    def new(
        cls,
        ring: Ring,
        matrices: Sequence[SparseMatrix],
        z: torch.Tensor,
        l_in: int,
        b: int,
        k: int,
        scheme: AjtaiScheme,
    ) -> "ComR1CS":
        f = gadget_decompose_vec(ring, z, b, k)
        if f.shape[0] < scheme.n:
            # m k < n (k 3 or 5 at a power-of-two n): zero rows up to the
            # scheme's width, where the JAX package raises; the zero rows
            # satisfy every padded constraint row
            f = torch.cat([f, f.new_zeros((scheme.n - f.shape[0],) + tuple(f.shape[1:]))])
        cm_f = [ring.icrt_host(c) for c in rops.to_host(ring, scheme.commit_device(f))]
        return cls(x=ComR1CSX(matrices=list(matrices), z=z, cm_f=cm_f, l_in=l_in), f=f)


@dataclass
class ComR1CSProof:
    """r1cs.rs:37-46."""

    sumcheck: psc.SumcheckProof
    nvars: int
    r: List[int]
    v: list
    va: list
    vb: list
    vc: list


def _r1cs_comb(ring: Ring) -> psc.CombFn:
    def fn(vals, consts):
        diff = mo.sub(ring.fq, rops.ext_mul(ring, vals[1], vals[2]), vals[3])
        return rops.ext_mul(ring, vals[0], diff)

    return psc.CombFn(fn, scalar=False)


def linearize(c: ComR1CS, transcript: PlusTranscript) -> Tuple[LinB, ComR1CSProof]:
    """r1cs.rs:74-133."""
    ring = c.x.matrices[0].ring
    dev = c.f.device
    n = c.f.shape[0]
    nvars = (n - 1).bit_length()
    A, B, C = c.x.matrices

    ga = A.mat_vec(c.f)
    gb = B.mat_vec(c.f)
    gc = C.mat_vec(c.f)

    r = transcript.get_challenges(nvars)
    eq_ring = scalar_to_ring_table(ring, mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, r, dev)))
    mles = torch.stack([eq_ring, ga, gb, gc])
    del eq_ring

    proof_sc, ro, _ = psc.prove(ring, transcript, mles, nvars, 3, _r1cs_comb(ring))

    eq_ro = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, ro, dev))
    mles[0] = c.f  # the eq table's slot now holds f: open f, ga, gb, gc
    opened = rops.to_host(ring, mleops.eval_ring_mles_scalar(ring, mles, eq_ro))
    v, va, vb, vc = [ring.icrt_host(o) for o in opened]

    for e in (v, va, vb, vc):
        transcript.absorb_coeffs(e)

    proof = ComR1CSProof(sumcheck=proof_sc, nvars=nvars, r=ro, v=v, va=va, vb=vb, vc=vc)
    linb = LinB(
        f=c.f,
        x=LinBX(cm_f=list(c.x.cm_f), r=[(x, x) for x in ro], v=[(v, v), (va, va), (vb, vb), (vc, vc)]),
    )
    return linb, proof


class R1CSLinError(Exception):
    pass


def verify_linearization(ring: Ring, proof: ComR1CSProof, transcript: PlusTranscript):
    """r1cs.rs:136-163."""
    r = transcript.get_challenges(proof.nvars)
    ro, s = psc.verify(ring, transcript, proof.nvars, 3, cr.czero(ring), proof.sumcheck)
    for e in (proof.v, proof.va, proof.vb, proof.vc):
        transcript.absorb_coeffs(e)
    e = psc.eq_eval_scalar(ring, r, ro)
    lhs = cr.cscale(ring, e, cr.csub(ring, cr.cmul(ring, proof.va, proof.vb), proof.vc))
    if lhs != list(s):
        raise R1CSLinError("linearization claim check failed")
