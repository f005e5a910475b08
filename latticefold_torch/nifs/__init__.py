"""LatticeFold NIFS: the non-interactive folding scheme orchestrator.

Compose linearization -> decomposition x2 -> folding, with the public input
absorbed under "acc"/"cm_i" domain tags. The prover runs on the device of
its witnesses and scheme; the verifier is host code.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..arith.ccs import CCCS, CCS, LCCCS
from ..arith.witness import Witness
from ..commitment import AjtaiScheme
from ..params import DecompositionParams
from ..transcript import Transcript
from . import decomposition, folding, linearization


@dataclass
class LFProof:
    linearization_proof: linearization.LinearizationProof
    decomposition_proof_l: decomposition.DecompositionProof
    decomposition_proof_r: decomposition.DecompositionProof
    folding_proof: folding.FoldingProof


def absorb_public_input(ring, acc: LCCCS, cm_i: CCCS, transcript: Transcript):
    transcript.absorb_tag(b"acc")
    transcript.absorb_slice([ring.embed_k(r) for r in acc.r])
    transcript.absorb_slice(acc.v)
    transcript.absorb_slice(acc.cm.vals)
    transcript.absorb_slice(acc.u)
    transcript.absorb_slice(acc.x_w)
    transcript.absorb(acc.h)
    transcript.absorb_tag(b"cm_i")
    transcript.absorb_slice(cm_i.cm.vals)
    transcript.absorb_slice(cm_i.x_ccs)


def prove(
    acc: LCCCS,
    w_acc: Witness,
    cm_i: CCCS,
    w_i: Witness,
    transcript: Transcript,
    ccs: CCS,
    scheme: AjtaiScheme,
    dp: DecompositionParams,
):
    """Returns (folded LCCCS, folded Witness, LFProof)."""
    ring = ccs.ring
    ccs.sanity_check(dp.L)
    absorb_public_input(ring, acc, cm_i, transcript)

    linearized_cm_i, lin_proof = linearization.prove(cm_i, w_i, transcript, ccs)
    z_l, lcccs_l, wit_l, dec_proof_l = decomposition.prove(
        acc, w_acc, transcript, ccs, scheme, dp
    )
    z_r, lcccs_r, wit_r, dec_proof_r = decomposition.prove(
        linearized_cm_i, w_i, transcript, ccs, scheme, dp
    )
    folded_lcccs, w_0, fold_proof = folding.prove(
        lcccs_l + lcccs_r, wit_l + wit_r, transcript, ccs, dp, z_l + z_r
    )
    return folded_lcccs, w_0, LFProof(
        linearization_proof=lin_proof,
        decomposition_proof_l=dec_proof_l,
        decomposition_proof_r=dec_proof_r,
        folding_proof=fold_proof,
    )


def verify(
    acc: LCCCS,
    cm_i: CCCS,
    proof: LFProof,
    transcript: Transcript,
    ccs: CCS,
    dp: DecompositionParams,
):
    ring = ccs.ring
    ccs.sanity_check(dp.L)
    absorb_public_input(ring, acc, cm_i, transcript)

    linearized_cm_i = linearization.verify(cm_i, proof.linearization_proof, transcript, ccs)
    dec_acc = decomposition.verify(acc, proof.decomposition_proof_l, transcript, ccs, dp)
    dec_cm_i = decomposition.verify(
        linearized_cm_i, proof.decomposition_proof_r, transcript, ccs, dp
    )
    return folding.verify(dec_acc + dec_cm_i, proof.folding_proof, transcript, ccs, dp)
