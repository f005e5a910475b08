"""LatticeFold NIFS: the non-interactive folding scheme orchestrator.

Compose linearization -> decomposition x2 -> folding, with the public input
absorbed under "acc"/"cm_i" domain tags. The prover runs on the device of
its witnesses and scheme; the verifier is host code.

The prover takes one of two paths with the same proof: the standard one,
or the big-m one (the decomposition's digit rows in a shared arena, the
folding sumcheck's f-hat rows kept subfield-compact through its first
rounds), which holds far less device memory at large m. ``use_big_m``
chooses between them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

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


# The standard path's peak device memory per constraint, bytes / m, from
# chip_smoke.py's folds at wit_len 4096 (m 2^15; BabyBear m 2^14) on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit (torch's
# max_memory_allocated over a counted prove and timed proves): Goldilocks
# 9676846592 B, Frog 5903784960 B, BabyBear 13812001792 B, Stark
# 27568408064 B. The peak is linear in m: chip_smoke.peak_sweep measured
# Goldilocks at m 2^16 and 2^17 within 1 % of m times the 2^15 figure,
# and its standard prove at m 2^18 ran out of the card's memory. The port
# keeps u32 limbs in int64 lanes, so these are twice a u32 layout's bytes.
STANDARD_PEAK_BYTES_PER_CONSTRAINT = {
    "goldilocks": 9676846592 / (1 << 15),
    "frog": 5903784960 / (1 << 15),
    "babybear": 13812001792 / (1 << 14),
    "stark": 27568408064 / (1 << 15),
}
# the share of the device's memory the standard path's estimated peak may
# take: the caching allocator held 1.6 times the allocated peak in
# peak_sweep's standard folds (max_memory_reserved), so an allocated peak
# of 0.6 of the card reserves up to 0.96 of it
STANDARD_PEAK_SHARE = 0.6


def big_m_rule(ring_name: str, m: int, memory_bytes: int) -> bool:
    """True when the standard path's estimated peak at ``m`` constraints
    (STANDARD_PEAK_BYTES_PER_CONSTRAINT[ring] * m; the largest figure for
    a ring without one) exceeds STANDARD_PEAK_SHARE of ``memory_bytes``:
    the big-m path then. Elsewhere the standard path, which launches fewer
    and larger kernels."""
    per = STANDARD_PEAK_BYTES_PER_CONSTRAINT.get(
        ring_name, max(STANDARD_PEAK_BYTES_PER_CONSTRAINT.values())
    )
    return per * m > STANDARD_PEAK_SHARE * memory_bytes


def device_memory(device: torch.device) -> int:
    """Bytes of memory the prover's tensors live in: the card's total
    memory, or the host's physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def use_big_m(ring_name: str, m: int, device: torch.device) -> bool:
    """The path ``prove`` takes when not told: ``big_m_rule`` on the
    memory of ``device``."""
    return big_m_rule(ring_name, m, device_memory(device))


def prove(
    acc: LCCCS,
    w_acc: Witness,
    cm_i: CCCS,
    w_i: Witness,
    transcript: Transcript,
    ccs: CCS,
    scheme: AjtaiScheme,
    dp: DecompositionParams,
    big_m: Optional[bool] = None,
    expand_nvars: int = 13,
):
    """Returns (folded LCCCS, folded Witness, LFProof).

    ``big_m``: True or False forces the big-m or the standard path; None
    lets ``use_big_m`` choose from the ring, m and the device's memory.
    ``expand_nvars``: on the big-m path, the number of variables left when
    the f-hat rows are expanded (the first log m - expand_nvars sumcheck
    rounds fold them through the weight tensor). Both paths give the same
    proof."""
    ring = ccs.ring
    ccs.sanity_check(dp.L)
    dev = w_i.f.device
    if big_m is None:
        big_m = use_big_m(ring.name, ccs.m, dev)
    absorb_public_input(ring, acc, cm_i, transcript)

    linearized_cm_i, lin_proof = linearization.prove(cm_i, w_i, transcript, ccs)
    arena = decomposition.Arena.allocate(ring, dp, ccs.m, w_i.f.shape[0], dev) if big_m else None
    z_l, lcccs_l, wit_l, dec_proof_l = decomposition.prove(
        acc, w_acc, transcript, ccs, scheme, dp, arena=arena, slot0=0
    )
    z_r, lcccs_r, wit_r, dec_proof_r = decomposition.prove(
        linearized_cm_i, w_i, transcript, ccs, scheme, dp, arena=arena, slot0=dp.K
    )
    folded_lcccs, w_0, fold_proof = folding.prove(
        lcccs_l + lcccs_r, wit_l + wit_r, transcript, ccs, dp, z_l + z_r,
        arena=arena, expand_nvars=expand_nvars,
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
