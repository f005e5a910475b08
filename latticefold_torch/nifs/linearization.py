"""Linearization subprotocol (LatticeFold Fig. 5).

Prove that a committed CCS instance satisfies the relation by a
degree-(d+1) sumcheck of g(x) = eq(beta, x) * sum_i c_i prod_{j in S_i}
mle[M_j z](x), then emit v = f_hat(r) and u_j = mle[M_j z](r).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from .. import sumcheck as sc
from ..arith.ccs import CCCS, CCS, LCCCS
from ..arith.witness import Witness
from ..poly import mle as mlemod
from ..rings import ops as rops
from ..rings.construct import Ring
from ..transcript import Transcript


@dataclass
class LinearizationProof:
    sumcheck: sc.SumcheckProof
    v: List[tuple]
    u: List[tuple]


class LinearizationError(Exception):
    pass


def _squeeze_beta(ring: Ring, transcript: Transcript, n: int):
    """Tag then n challenges."""
    transcript.absorb_tag(b"beta_s")
    return transcript.get_challenges(n)


def _lin_comb(ring: Ring, S: tuple, c: tuple, device):
    """comb_fn for sum_i c_i * prod_{j in S_i} vals[pos] times eq (last mle).

    MLE list order: for each i with c_i != 0, the MLEs M_j z for j in S_i are
    pushed in order; eq(beta, x) is last.
    """
    ks = {ci: rops.k_to_device(ring, ring.K.embed(ci), device) for ci in c if ci not in (0, 1, -1)}

    def fn(vals, consts):
        acc = None
        pos = 0
        for ci, Si in zip(c, S):
            if ci == 0:
                continue
            term = vals[pos]
            pos += 1
            for _ in range(1, len(Si)):
                term = rops.ring_mul(ring, term, vals[pos])
                pos += 1
            if ci == -1:
                acc = rops.ring_sub(ring, torch.zeros_like(term), term) if acc is None else rops.ring_sub(ring, acc, term)
            elif ci == 1:
                acc = term if acc is None else rops.ring_add(ring, acc, term)
            else:
                term = rops.scalar_mul(ring, term, ks[ci])
                acc = term if acc is None else rops.ring_add(ring, acc, term)
        return rops.ring_mul(ring, acc, vals[-1])

    return fn


def compute_z_device(ring: Ring, x_host: list, w_ccs):
    """z = x || 1 || w as a tensor [n, ncomp, e, nl] on w_ccs's device."""
    head = rops.to_device(ring, list(x_host) + [ring.one()], w_ccs.device)
    return torch.cat([head, w_ccs], dim=0)


def calculate_Mz_mles(ring: Ring, ccs: CCS, z_dev):
    """[t, m, ncomp, e, nl] stacked mle[M_j z] tables."""
    return torch.stack([M.mat_vec(z_dev) for M in ccs.M])


def prove(cm_i: CCCS, wit: Witness, transcript: Transcript, ccs: CCS):
    """Returns (LCCCS, LinearizationProof)."""
    ring = ccs.ring
    dev = wit.w_ccs.device
    z = compute_z_device(ring, cm_i.x_ccs, wit.w_ccs)

    beta_s = _squeeze_beta(ring, transcript, ccs.s)
    Mz = calculate_Mz_mles(ring, ccs, z)

    # sumcheck MLE list: selected Mz copies + eq(beta)
    sel = [Mz[j] for i, Si in enumerate(ccs.S) if ccs.c[i] != 0 for j in Si]
    eq = mlemod.build_eq(ring, mlemod.point_to_device(ring, beta_s, dev))
    mles = torch.stack(sel + [eq])

    comb = _lin_comb(ring, tuple(tuple(s) for s in ccs.S), tuple(ccs.c), dev)
    degree = ccs.d + 1
    proof_sc, point_r, _ = sc.prove(ring, transcript, mles, ccs.s, degree, comb)

    # v = f_hat evals, u = Mz evals at r
    rs = mlemod.point_to_device(ring, point_r, dev)
    v = list(rops.to_host(ring, mlemod.evaluate_subfield(ring, wit.f_hat, rs)))
    u = list(rops.to_host(ring, mlemod.evaluate(ring, Mz, rs)))

    transcript.absorb_slice(v)
    transcript.absorb_slice(u)

    proof = LinearizationProof(sumcheck=proof_sc, v=v, u=u)
    lcccs = LCCCS(r=point_r, v=v, cm=cm_i.cm, u=u, x_w=list(cm_i.x_ccs), h=ring.one())
    return lcccs, proof


def verify(cm_i: CCCS, proof: LinearizationProof, transcript: Transcript, ccs: CCS):
    """Host verifier."""
    ring = ccs.ring
    beta_s = _squeeze_beta(ring, transcript, ccs.s)

    point_r, s = sc.verify(
        ring, transcript, ccs.s, ccs.d + 1, ring.zero(), proof.sumcheck
    )

    # e * sum_i c_i prod u_j == s
    e = sc.eq_eval(ring, point_r, beta_s)
    total = ring.zero()
    for ci, Si in zip(ccs.c, ccs.S):
        term = ring.embed_int(ci)
        for j in Si:
            term = ring.rmul(term, proof.u[j])
        total = ring.radd(total, term)
    if ring.rmul(e, total) != s:
        raise LinearizationError("evaluation claim check failed")

    transcript.absorb_slice(proof.v)
    transcript.absorb_slice(proof.u)

    return LCCCS(
        r=point_r, v=list(proof.v), cm=cm_i.cm, u=list(proof.u),
        x_w=list(cm_i.x_ccs), h=ring.one(),
    )
