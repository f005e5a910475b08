"""LatticeFold+ top-level prover/verifier.

Port of the reference's plus.rs: the prover keeps an accumulator of LinB
instances; each ``prove`` linearizes the incoming computation instances,
folds everything with mlin, decomposes the folded witness B^2 -> 2 x B,
and keeps the two decomposed instances as the new accumulator
(plus.rs:77-108). The verifier replays the linearization proofs, the
commitment-transformation proof, and the decomposition recomposition
(plus.rs:133-142). Tensors live where the scheme's matrix and the
instances' witnesses do (``AjtaiScheme(..., device=None)``: the card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence

from ..arith.sparse import SparseMatrix
from ..commitment import AjtaiScheme
from ..rings.construct import Ring
from . import decomp as decomp_mod
from . import r1cs as r1cs_mod
from .cm import CmProof, cm_verify
from .mlin import LinB2X, LinParameters, Mlin
from .transcript import PlusTranscript


def estimate_bound(sop: int, L: int, d: int, k: int) -> int:
    """Norm-bound estimate via the quadratic formula (plus utils.rs:102-112)."""
    a = sop * L
    c = d // 2 + d * k + 1
    disc = float(a * a + 4 * a * c)
    b = (a + math.sqrt(disc)) / 2.0
    return int(math.ceil(b))


@dataclass
class PlusParameters:
    """plus.rs:42-46."""

    lin: LinParameters
    B: int


@dataclass
class PlusProof:
    """plus.rs:34-40."""

    linb2x: LinB2X
    lproof: List[r1cs_mod.ComR1CSProof]
    cmproof: CmProof
    dproof: decomp_mod.DecompProof


@dataclass
class PlusProver:
    """plus.rs:15-23, 48-108."""

    scheme: AjtaiScheme
    M: List[SparseMatrix]
    transcript: PlusTranscript
    params: PlusParameters
    acc: Mlin = field(init=False)

    def __post_init__(self):
        self.acc = Mlin(lins=[], params=self.params.lin)

    def prove(self, comp: Sequence[r1cs_mod.ComR1CS]) -> PlusProof:
        ring = self.scheme.ring
        lproof = []
        for ci in comp:
            linb, lp = r1cs_mod.linearize(ci, self.transcript)
            lproof.append(lp)
            self.acc.lins.append(linb)

        linb2, cmproof = self.acc.mlin(self.scheme, self.M, self.transcript)

        (l0, l1), dproof = decomp_mod.decompose(ring, linb2.g, linb2.x.ro, self.M, self.scheme, self.params.B)

        proof = PlusProof(linb2x=linb2.x, lproof=lproof, cmproof=cmproof, dproof=dproof)
        self.acc.lins = [l0, l1]
        return proof


@dataclass
class PlusVerifier:
    """plus.rs:26-32, 111-142."""

    ring: Ring
    M: List[SparseMatrix]
    transcript: PlusTranscript
    params: PlusParameters

    def verify(self, proof: PlusProof) -> bool:
        for lp in proof.lproof:
            r1cs_mod.verify_linearization(self.ring, lp, self.transcript)
        cm_verify(self.ring, proof.cmproof, self.M, self.transcript)
        decomp_mod.verify(self.ring, proof.dproof, proof.linb2x.cm_g, proof.linb2x.vo, self.params.B)
        return True
