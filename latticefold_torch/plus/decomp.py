"""Decomposition step (LatticeFold+ Construction 5.3).

Port of the reference's decomp.rs: split the folded witness g (norm < B^2)
into two base-B digit witnesses F0, F1 with commitments C_i = A F_i (one
batch commit) and MLE openings at both components of the paired point r;
the verifier recomposes commitments and evaluations with powers of B
(decomp.rs:101-123).
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
from .mlin import LinB, LinBX


@dataclass
class DecompProof:
    """decomp.rs:20-25."""

    C: Tuple[List[list], List[list]]  # kappa coeff lists x 2
    v: Tuple[List[Tuple[list, list]], List[Tuple[list, list]]]


class DecompError(Exception):
    pass


def decompose(
    ring: Ring,
    f: torch.Tensor,
    r: List[Tuple[int, int]],
    M: Sequence[SparseMatrix],
    scheme: AjtaiScheme,
    B: int,
) -> Tuple[Tuple[LinB, LinB], DecompProof]:
    """decomp.rs:32-98."""
    dev = f.device
    f_coeff = mo.from_mont(ring.fq, rops.icrt(ring, f))
    digs = mo.signed_digits(ring.fq, f_coeff, B, 2)  # [n, d, 2]
    Fs = [rops.crt(ring, mo.to_mont(ring.fq, mo.digits_to_field(ring.fq, digs[..., i]))) for i in range(2)]
    del f_coeff, digs

    cms_host = rops.to_host(ring, scheme.commit_batch(torch.stack(Fs, dim=1)))  # [kappa, 2]
    C = tuple([ring.icrt_host(cms_host[i, b]) for i in range(scheme.kappa)] for b in range(2))

    eq_a = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, [rr[0] for rr in r], dev))
    eq_b = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, [rr[1] for rr in r], dev))

    def open_all(Fi) -> List[Tuple[list, list]]:
        stack = torch.cat([Fi[None], torch.stack([Mi.mat_vec(Fi) for Mi in M])]) if M else Fi[None]
        va = rops.to_host(ring, mleops.eval_ring_mles_scalar(ring, stack, eq_a))
        vb = rops.to_host(ring, mleops.eval_ring_mles_scalar(ring, stack, eq_b))
        return [(ring.icrt_host(a), ring.icrt_host(b)) for a, b in zip(va, vb)]

    v0 = open_all(Fs[0])
    v1 = open_all(Fs[1])

    linb0 = LinB(f=Fs[0], x=LinBX(cm_f=list(C[0]), r=list(r), v=v0))
    linb1 = LinB(f=Fs[1], x=LinBX(cm_f=list(C[1]), r=list(r), v=v1))
    return (linb0, linb1), DecompProof(C=C, v=(v0, v1))


def verify(ring: Ring, proof: DecompProof, cm_f: List[list], v: List[Tuple[list, list]], B: int):
    """decomp.rs:101-123: recompose with powers of B and compare."""
    Bq = B % ring.q

    def recompose_pair(a, b):
        return cr.cadd(ring, a, cr.cscale(ring, Bq, b))

    rec_cm = [recompose_pair(c0, c1) for c0, c1 in zip(proof.C[0], proof.C[1])]
    if rec_cm != [list(c) for c in cm_f]:
        raise DecompError("commitment recomposition failed")

    rec_v = [
        (recompose_pair(p0[0], p1[0]), recompose_pair(p0[1], p1[1]))
        for p0, p1 in zip(proof.v[0], proof.v[1])
    ]
    ref = [(list(a), list(b)) for a, b in v]
    got = [(list(a), list(b)) for a, b in rec_v]
    if got != ref:
        raise DecompError("evaluation recomposition failed")
