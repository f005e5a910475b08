"""Decomposition subprotocol.

Split one LCCCS of norm bound B into K instances of bound b. The witness
digits are extracted on the device; the statement split is host-side (l+1
elements). The K-1 digit witnesses y_1..y_{K-1} are committed as one
component-major batch through the byte-plane route
(``AjtaiScheme.commit_batch_fused``); the first commitment is derived
homomorphically:
y_0 = cm - b * sum_{i>=1} b^{i-1} y_i.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from .. import modops as mo
from ..arith.ccs import CCS, Commitment, LCCCS
from ..arith.witness import Witness
from ..commitment import AjtaiScheme
from ..params import DecompositionParams
from ..poly import mle as mlemod
from ..rings import ops as rops
from ..rings import plane_commit
from ..rings.construct import Ring
from ..transcript import Transcript


class DecompositionError(Exception):
    pass


@dataclass
class DecompositionProof:
    u_s: List[List[tuple]]
    v_s: List[List[tuple]]
    x_s: List[List[tuple]]
    y_s: List[Commitment]


# ---------------------------------------------------------------------------
# host balanced digits (same half-toward-zero semantics as modops.signed_digits)
# ---------------------------------------------------------------------------


def host_balanced_digits(q: int, x: int, base: int, nd: int) -> List[int]:
    s = x if x <= q // 2 else x - q
    neg, mag = s < 0, abs(s)
    digs = []
    for _ in range(nd):
        r = mag % base
        quo = mag // base
        if 2 * r > base:
            r -= base
            quo += 1
        digs.append(-r if neg else r)
        mag = quo
    assert mag == 0, "not enough digits"
    return digs


def decompose_big_vec_into_k_vec_and_compose_back(
    ring: Ring, dp: DecompositionParams, x: List[tuple]
) -> List[List[tuple]]:
    """ICRT -> radix-B (L digits) -> radix-b (K digits) -> transpose ->
    recompose L-chunks with B -> CRT. Host-side (x is short)."""
    q = ring.q
    coeffs = [ring.icrt_host(e) for e in x]  # m_x lists of d ints
    # gadget decompose: element i -> L digit elements (i*L + j)
    decomposed_B: List[List[int]] = []
    for c in coeffs:
        digs_per_coeff = [host_balanced_digits(q, v, dp.B, dp.L) for v in c]
        for j in range(dp.L):
            decomposed_B.append([digs_per_coeff[t][j] % q for t in range(ring.d)])
    # decompose each radix-B digit element into K radix-b digit elements
    k_vecs: List[List[List[int]]] = [[] for _ in range(dp.K)]
    for elem in decomposed_B:
        digs_per_coeff = [host_balanced_digits(q, v, dp.b, dp.K) for v in elem]
        for k in range(dp.K):
            k_vecs[k].append([digs_per_coeff[t][k] % q for t in range(ring.d)])
    # recompose chunks of L with powers of B, then CRT
    out = []
    for k in range(dp.K):
        vec = []
        rows = k_vecs[k]
        for i in range(0, len(rows), dp.L):
            acc = [0] * ring.d
            for j in range(dp.L):
                Bj = pow(dp.B, j, q)
                acc = [(a + Bj * v) % q for a, v in zip(acc, rows[i + j])]
            vec.append(ring.crt_host(acc))
        out.append(vec)
    return out


@dataclass
class Arena:
    """The big-m path's shared tables: the 2K digit witnesses' rows, filled
    by the two decompositions (the left side's K in slots 0..K-1, the
    right side's in K..2K-1) and read by the folding prover in place, so
    that no [2K, ...] stack is made beside the witnesses' own tensors.

    fhat: [2K, tau, m, ncomp, nl] subfield-compact f-hat rows (None once the
    sumcheck has freed them); f: [2K, NL, ncomp, e, nl] (None once the
    rho-fold has read them)."""

    fhat: Optional[torch.Tensor]
    f: Optional[torch.Tensor]

    @classmethod
    def allocate(cls, ring: Ring, dp: DecompositionParams, m: int, NL: int, device) -> "Arena":
        return cls(
            fhat=torch.empty((2 * dp.K, ring.tau, m, ring.ncomp, ring.nl), dtype=torch.int64, device=device),
            f=torch.empty((2 * dp.K, NL, ring.ncomp, ring.e, ring.nl), dtype=torch.int64, device=device),
        )


def decompose_witness(
    ring: Ring, dp: DecompositionParams, wit: Witness, n_pad: int,
    arena: Optional[Arena] = None, slot0: int = 0,
) -> List[Witness]:
    """Balanced base-b digits of f_coeff, then Witness.from_f_coeff per digit.

    With ``arena``: each digit witness's f_hat and f are copied into the
    arena's rows slot0 + k as it is made, and the witness's own tensors
    (f_hat, f, f_coeff) are dropped; consumers read the arena's rows."""
    digs = mo.signed_digits(ring.fq, wit.f_coeff, dp.b, dp.K)  # [NL, d, K]
    out = []
    for k in range(dp.K):
        w = Witness.from_f_coeff(ring, dp, mo.digits_to_field(ring.fq, digs[..., k]), n_pad)
        if arena is not None:
            arena.fhat[slot0 + k].copy_(w.f_hat)
            arena.f[slot0 + k].copy_(w.f)
            w.f_hat = w.f = w.f_coeff = None
        out.append(w)
    return out


def digit_batch(ring: Ring, fs):
    """The digit witnesses' f rows (a sequence of [n, ncomp, e, nl] tensors,
    or a [Nb, n, ...] tensor such as the arena's rows) as one
    component-major batch [ncomp, n, e, Nb, nl] in
    ``plane_commit.empty_batch``'s layout, the one the byte-plane commit
    reads on the card: one copy, as a stack on the batch dimension is."""
    batch = plane_commit.empty_batch(ring, fs[0].shape[0], len(fs), fs[0].device)
    for i, f in enumerate(fs):
        batch[:, :, :, i] = f.permute(1, 0, 2, 3)
    return batch


def _dot_rows(ring: Ring, wT, z):
    """<z, wT_j> per row: wT [t, N, ...], z [N, ...] -> [t, ncomp, e, nl]."""
    return rops.ring_sum(ring, rops.ring_mul(ring, wT, z[None]), 1)


def prove(
    cm_i: LCCCS,
    wit: Witness,
    transcript: Transcript,
    ccs: CCS,
    scheme: AjtaiScheme,
    dp: DecompositionParams,
    arena: Optional[Arena] = None,
    slot0: int = 0,
):
    """Returns (z_s, lcccs_s, wit_s, proof).

    z_s: the K z-vectors (x_k || w_ccs_k), retained for the folding prover's
    streaming Mz evaluations in place of materialized Mz MLEs.
    ``arena`` / ``slot0``: the big-m path's shared tables (see ``Arena``);
    the digit witnesses' rows go to slots slot0..slot0+K-1.
    """
    ring = ccs.ring
    ccs.sanity_check(dp.L)
    dev = wit.f.device

    wit_s = decompose_witness(ring, dp, wit, ccs.m, arena=arena, slot0=slot0)
    if arena is not None:
        f_s = arena.f[slot0 : slot0 + dp.K]
        fhat_s = arena.fhat[slot0 : slot0 + dp.K]
    else:
        f_s = [w.f for w in wit_s]
        fhat_s = [w.f_hat for w in wit_s]
    x_s = decompose_big_vec_into_k_vec_and_compose_back(
        ring, dp, list(cm_i.x_w) + [cm_i.h]
    )

    # commitments: y_1..y_{K-1} as one component-major batch through the
    # byte-plane route (kernels A and B); y_0 derived homomorphically
    commitments_k1 = []
    if dp.K > 1:
        batch = digit_batch(ring, f_s[1:])
        cms_host = rops.to_host(ring, scheme.commit_batch_fused(batch))
        del batch
        commitments_k1 = [
            Commitment(ring, list(cms_host[:, i])) for i in range(dp.K - 1)
        ]
    b_elt = ring.embed_int(dp.b)
    b_sum = Commitment.zeroed(ring, scheme.kappa)
    for y_i in reversed(commitments_k1):
        b_sum = (b_sum + y_i).mul_ring(b_elt)
    y_s = [cm_i.cm - b_sum] + commitments_k1

    rs = mlemod.point_to_device(ring, cm_i.r, dev)
    v_s = [
        list(rops.to_host(ring, mlemod.evaluate_subfield(ring, fhat, rs)))
        for fhat in fhat_s
    ]
    del f_s, fhat_s

    # u_k[j] = mle[M_j z_k](r) = <M_j z_k, eq_r> = <z_k, M_j^T eq_r>: the t
    # transposed-SpMV vectors are shared across all K instances (exact mod-q
    # identity, so the values equal the retained-Mz evaluation)
    eq_r = mlemod.build_eq(ring, rs)  # [m, ncomp, e, nl]
    wT = torch.stack([M.transpose().mat_vec(eq_r) for M in ccs.M])  # [t, ncols, ...]
    z_s = []
    u_s = []
    for k in range(dp.K):
        z = torch.cat([rops.to_device(ring, x_s[k], dev), wit_s[k].w_ccs], dim=0)
        z_s.append(z)
        u_s.append(list(rops.to_host(ring, _dot_rows(ring, wT, z))))

    lcccs_s = []
    for k in range(dp.K):
        transcript.absorb_slice(x_s[k])
        transcript.absorb_slice(y_s[k].vals)
        transcript.absorb_slice(u_s[k])
        transcript.absorb_slice(v_s[k])
        lcccs_s.append(
            LCCCS(
                r=list(cm_i.r), v=v_s[k], cm=y_s[k], u=u_s[k],
                x_w=x_s[k][:-1], h=x_s[k][-1],
            )
        )

    proof = DecompositionProof(u_s=u_s, v_s=v_s, x_s=x_s, y_s=y_s)
    return z_s, lcccs_s, wit_s, proof


def verify(
    cm_i: LCCCS,
    proof: DecompositionProof,
    transcript: Transcript,
    ccs: CCS,
    dp: DecompositionParams,
):
    """Host verifier."""
    ring = ccs.ring
    lcccs_s = []
    for k in range(dp.K):
        x, y, u, v = proof.x_s[k], proof.y_s[k], proof.u_s[k], proof.v_s[k]
        transcript.absorb_slice(x)
        transcript.absorb_slice(y.vals)
        transcript.absorb_slice(u)
        transcript.absorb_slice(v)
        lcccs_s.append(
            LCCCS(r=list(cm_i.r), v=list(v), cm=y, u=list(u), x_w=x[:-1], h=x[-1])
        )

    b_s = [ring.embed_int(dp.b**i) for i in range(dp.K)]

    def recompose(vecs):
        length = len(vecs[0])
        return [
            _linear_combo(ring, [vec[j] for vec in vecs], b_s) for j in range(length)
        ]

    y = Commitment.zeroed(ring, len(cm_i.cm.vals))
    for y_k, b_k in zip(proof.y_s, b_s):
        y = y + y_k.mul_ring(b_k)
    if y != cm_i.cm:
        raise DecompositionError("commitment recomposition failed")

    if recompose(proof.v_s) != list(cm_i.v):
        raise DecompositionError("v recomposition failed")
    if recompose(proof.u_s) != list(cm_i.u):
        raise DecompositionError("u recomposition failed")
    x_w = recompose(proof.x_s)
    h = x_w.pop()
    if x_w != list(cm_i.x_w) or h != cm_i.h:
        raise DecompositionError("statement recomposition failed")

    return lcccs_s


def _linear_combo(ring: Ring, elts, coeffs):
    acc = ring.zero()
    for e, c in zip(elts, coeffs):
        acc = ring.radd(acc, ring.rmul(e, c))
    return acc
