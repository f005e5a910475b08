"""Folding subprotocol.

Folds 2K decomposed LCCCS instances into one via a degree-2b batched
sumcheck over

  g = sum_i [ alpha-powers * (eq(r_i,x) * f_hat_i) ]        (g1, eval claims)
    + sum_i [ mu-powers * (eq(beta,x) * range-product) ]    (g2, norm check)
    + sum_i [ zeta-powers * (eq(r_i,x) * Mz_i) ]            (g3, lin claims)

followed by short-rho folding of witnesses, commitments and claims, with the
f-hat claim folded through RotSum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from .. import modops as mo
from .. import sumcheck as sc
from ..arith.ccs import CCS, Commitment, LCCCS
from ..arith.witness import Witness
from ..params import DecompositionParams
from ..poly import mle as mlemod
from ..rings import ops as rops
from ..rings.construct import Ring
from ..transcript import Transcript


class FoldingError(Exception):
    pass


@dataclass
class FoldingProof:
    sumcheck: sc.SumcheckProof
    theta_s: List[List[tuple]]  # 2K x tau ring elements
    eta_s: List[List[tuple]]  # 2K x t ring elements


# ---------------------------------------------------------------------------
# challenges
# ---------------------------------------------------------------------------


def squeeze_alpha_beta_zeta_mu(ring: Ring, transcript: Transcript, dp, log_m: int):
    transcript.absorb_tag(b"alpha_s")
    alpha_s = transcript.get_challenges(2 * dp.K)
    transcript.absorb_tag(b"zeta_s")
    zeta_s = transcript.get_challenges(2 * dp.K)
    transcript.absorb_tag(b"mu_s")
    mu_s = transcript.get_challenges(2 * dp.K - 1)  # one challenge less
    mu_s.append(ring.K.one())
    transcript.absorb_tag(b"beta_s")
    beta_s = transcript.get_challenges(log_m)
    return alpha_s, beta_s, zeta_s, mu_s


def get_rhos(ring: Ring, transcript: Transcript, dp):
    """2K-1 short challenges + ONE, in coefficient form + their CRT."""
    transcript.absorb_tag(b"rho_s")
    rhos_coeff = transcript.get_short_challenges(2 * dp.K - 1)
    one = [1] + [0] * (ring.d - 1)
    rhos_coeff.append(one)
    rhos_ntt = [ring.crt_host(c) for c in rhos_coeff]
    return rhos_coeff, rhos_ntt


# ---------------------------------------------------------------------------
# RotSum -- host side
# ---------------------------------------------------------------------------


def rot_lin_combination(ring: Ring, rho_coeff_s, theta_s):
    """v_0 = sum_i RotSum(rho_i, flatten(theta_i)); returns tau ring elements."""
    K = ring.K
    q = ring.q
    d = ring.d
    res = [K.zero()] * d
    for rho, theta in zip(rho_coeff_s, theta_s):
        flat = [comp for elt in theta for comp in elt]  # tau*ncomp K elements
        assert len(flat) == d
        cur = [c % q for c in rho]
        for i in range(d):
            b_i = flat[i]
            for j in range(d):
                if cur[j]:
                    res[j] = K.add(res[j], K.smul(cur[j], b_i))
            cur = ring.mul_by_x(cur)
    return [
        tuple(res[j * ring.ncomp + c] for c in range(ring.ncomp))
        for j in range(ring.tau)
    ]


# ---------------------------------------------------------------------------
# device: sumcheck MLE preparation
# ---------------------------------------------------------------------------


def prepare_folding_mles_streaming(
    ring: Ring, Khalf: int, f_hat_all, z_all, ccs, eq1, eq2, beta_eq, alphas, zetas
):
    """Stacked MLEs [5 + 2K*tau, m, ncomp, e, nl]:
    [eq(r_first), combined_1, eq(r_second), combined_2, eq(beta), f_hats...]:
    the five rows of ``prepare_folding_parts_grouped`` with every instance
    in one group, then the f-hat rows in full K form."""
    parts = prepare_folding_parts_grouped(
        ring, Khalf, f_hat_all, z_all, ccs, eq1, eq2, beta_eq, alphas, zetas, group=f_hat_all.shape[0]
    )
    fh_full = mlemod.expand_subfield(ring, f_hat_all)  # [2K, tau, m, c, e, nl]
    return torch.cat([parts, fh_full.reshape((-1,) + tuple(fh_full.shape[2:]))], dim=0)


def prepare_folding_parts_grouped(
    ring: Ring, Khalf: int, f_hat_all, z_all, ccs, eq1, eq2, beta_eq,
    alphas, zetas, group: int = 4,
):
    """The five expanded rows [5, m, ncomp, e, nl] = [eq(r_first),
    combined_1, eq(r_second), combined_2, eq(beta)]; on the big-m path the
    f-hat rows stay subfield-compact for ``sumcheck.prove_host_bigm``. The
    per-instance alpha / zeta Horner tables (the zeta terms M_j z_i made one
    j at a time by batched SpMV, no [2K, t, m] Mz tables) are built
    ``group`` instances at a time and summed straight into the two combined
    rows, so O(group m) ring elements are live instead of O(2K m). Modular
    sums are exact: the rows do not depend on ``group``."""
    twoK = f_hat_all.shape[0]
    combined = [None, None]
    for g0 in range(0, twoK, group):
        g1 = min(twoK, g0 + group)
        fh_h = _fhat_horner(ring, f_hat_all[g0:g1], alphas[g0:g1])
        mz_h = None
        zetas_dev = zetas[g0:g1, None, None]  # broadcast over (m, ncomp)
        for j in range(len(ccs.M) - 1, -1, -1):
            y_j = ccs.M[j].mat_vec_batched(z_all[g0:g1])  # [G, m, ...]
            cur = y_j if mz_h is None else rops.ring_add(ring, mz_h, y_j)
            mz_h = rops.ext_mul(ring, cur, zetas_dev)
        both = rops.ring_add(ring, fh_h, mz_h)  # [G, m, ...]
        del fh_h, mz_h
        split = min(max(Khalf - g0, 0), g1 - g0)  # the group's instances of the first half
        for half, lo, hi in ((0, 0, split), (1, split, g1 - g0)):
            if hi <= lo:
                continue
            part = rops.ring_sum(ring, both[lo:hi], 0)
            combined[half] = part if combined[half] is None else rops.ring_add(ring, combined[half], part)
    return torch.stack([eq1, combined[0], eq2, combined[1], beta_eq])


def _fhat_horner(ring: Ring, f_hat_all, alphas):
    """Per instance i: sum_row alpha_i^{row+1} * f_hat[i, row] on the
    subfield-compact rows [2K, tau, m, ncomp, nl] -> [2K, m, ncomp, e, nl]."""
    tau = f_hat_all.shape[1]
    ch = alphas[:, None, None]
    m = ring.fq
    mle = None
    for row in range(tau - 1, -1, -1):
        cur_sub = f_hat_all[:, row]  # [2K, m, ncomp, nl]
        if mle is None:
            mle = mo.mont_mul(m, cur_sub[..., None, :], ch)
        else:
            mle = mle.clone()
            mle[..., 0, :] = mo.add(m, mle[..., 0, :], cur_sub)
            mle = rops.ext_mul(ring, mle, ch)
    return mle


def _folding_comb(ring: Ring, two_k: int, tau: int, b_small: int, device):
    """sumcheck_polynomial_comb_fn, branchless. The degree-2b range product
    f * prod_{x=1}^{b-1}(f^2 - x^2) is evaluated as a balanced product tree
    (same mod-q work as the reference's sequential chain, logarithmic depth)."""
    squares = [rops.k_to_device(ring, ring.K.embed(x * x), device) for x in range(1, b_small)]

    def fn(vals, consts):
        mus = consts  # [2K, e, nl]
        res = rops.ring_add(
            ring,
            rops.ring_mul(ring, vals[0], vals[1]),
            rops.ring_mul(ring, vals[2], vals[3]),
        )
        eqb = vals[4]
        f = vals[5:]  # [2K*tau, M, ncomp, e, nl] -- batched across instances
        f2 = rops.ring_mul(ring, f, f)
        terms = [f] + [rops.ring_sub(ring, f2, c) for c in squares]  # f^2 - x^2
        while len(terms) > 1:
            nxt = [
                rops.ring_mul(ring, terms[i], terms[i + 1])
                for i in range(0, len(terms) - 1, 2)
            ]
            if len(terms) % 2:
                nxt.append(terms[-1])
            terms = nxt
        ev = rops.ring_mul(ring, terms[0], eqb[None])
        ev = ev.reshape((two_k, tau) + tuple(ev.shape[1:]))
        inter = None
        for dd in range(tau - 1, -1, -1):  # mu-Horner over the f-hat rows
            cur = ev[:, dd] if inter is None else rops.ring_add(ring, inter, ev[:, dd])
            inter = rops.ext_mul(ring, cur, mus[:, None, None])
        return rops.ring_add(ring, res, rops.ring_sum(ring, inter, 0))

    return fn


def _eta_dots(ring: Ring, z_all, wT):
    """eta[i, j] = <z_i, wT_j>: z_all [2K, N, ...], wT [t, N, ...] ->
    [2K, t, ncomp, e, nl], one [2K, N] product table at a time."""
    outs = []
    for j in range(wT.shape[0]):
        prod = rops.ring_mul(ring, z_all, wT[j][None])
        outs.append(rops.ring_sum(ring, prod, 1))
    return torch.stack(outs, dim=1)


def fold_witnesses(ring: Ring, f_all, rhos):
    """f_0 = sum_i rho_i * f_i; f_all [2K, NL, ...], rhos [2K, ncomp, e, nl]."""
    prod = rops.ring_mul(ring, f_all, rhos[:, None])
    return rops.ring_sum(ring, prod, 0)


def fold_witnesses_stream(ring: Ring, f_all, rhos):
    """``fold_witnesses`` one row of ``f_all`` at a time (the big-m path's
    form): the transient is one [NL, ...] product beside the accumulator
    instead of the [2K, NL, ...] product table, for 2K times the launches.
    Modular sums are exact, so the result is the same."""
    acc = None
    for f, rho in zip(f_all, rhos):
        term = rops.ring_mul(ring, f, rho)
        acc = term if acc is None else rops.ring_add(ring, acc, term)
        del term
    return acc


# ---------------------------------------------------------------------------
# host claim arithmetic
# ---------------------------------------------------------------------------


def _power_fold(ring: Ring, base_k, elts):
    """sum_j base^{j+1} * elts[j] (successors-style power combination)."""
    acc = ring.zero()
    power = base_k
    for e in elts:
        acc = ring.radd(acc, ring.rmul(ring.embed_k(power), e))
        power = ring.K.mul(power, base_k)
    return acc


def calculate_claims(ring: Ring, alpha_s, zeta_s, cm_i_s):
    claim_g1 = ring.zero()
    claim_g3 = ring.zero()
    for alpha, zeta, cm in zip(alpha_s, zeta_s, cm_i_s):
        claim_g1 = ring.radd(claim_g1, _power_fold(ring, alpha, cm.v))
        claim_g3 = ring.radd(claim_g3, _power_fold(ring, zeta, cm.u))
    return claim_g1, claim_g3


def expected_evaluation(ring: Ring, dp, alpha_s, mu_s, theta_s, e_ast, e_s, zeta_s, eta_s):
    """compute_sumcheck_claim_expected_value."""
    total = ring.zero()
    for i in range(2 * dp.K):
        # g1: evaluation claims
        s_i = ring.rmul(e_s[i], _power_fold(ring, alpha_s[i], theta_s[i]))
        # g2: norm range check
        range_terms = []
        for theta in theta_s[i]:
            prod = ring.one()
            for x in range(1, dp.b):
                xk = ring.embed_int(x)
                prod = ring.rmul(prod, ring.rmul(ring.rsub(theta, xk), ring.radd(theta, xk)))
            range_terms.append(ring.rmul(theta, prod))
        s_i = ring.radd(s_i, ring.rmul(e_ast, _power_fold(ring, mu_s[i], range_terms)))
        # g3: linearization claims
        s_i = ring.radd(s_i, ring.rmul(e_s[i], _power_fold(ring, zeta_s[i], eta_s[i])))
        total = ring.radd(total, s_i)
    return total


def compute_v0_u0_x0_cm0(ring: Ring, rho_coeff_s, rho_ntt_s, theta_s, cm_i_s, eta_s, ccs: CCS):
    v_0 = rot_lin_combination(ring, rho_coeff_s, theta_s)
    cm_0 = Commitment.zeroed(ring, len(cm_i_s[0].cm.vals))
    for rho, cm_i in zip(rho_ntt_s, cm_i_s):
        cm_0 = cm_0 + cm_i.cm.mul_ring(rho)
    u_0 = [ring.zero()] * ccs.t
    for rho, etas in zip(rho_ntt_s, eta_s):
        u_0 = [ring.radd(a, ring.rmul(rho, e)) for a, e in zip(u_0, etas)]
    x_0 = [ring.zero()] * (ccs.l + 1)
    for rho, cm_i in zip(rho_ntt_s, cm_i_s):
        xs = list(cm_i.x_w) + [cm_i.h]
        x_0 = [ring.radd(a, ring.rmul(rho, x)) for a, x in zip(x_0, xs)]
    return v_0, cm_0, u_0, x_0


# ---------------------------------------------------------------------------
# prover / verifier
# ---------------------------------------------------------------------------


def prove(
    cm_i_s: List[LCCCS],
    w_s: List[Witness],
    transcript: Transcript,
    ccs: CCS,
    dp: DecompositionParams,
    z_s: List,
    arena=None,
    expand_nvars: int = 13,
):
    """``z_s``: the 2K z-vectors from the two decomposition calls; Mz values
    are streamed from them (one SpMV batch per CCS matrix) rather than passed
    as materialized MLE tables.

    ``arena`` (a ``decomposition.Arena``) selects the big-m path: the
    witnesses' f_hat and f rows come from it, the f-hat rows stay
    subfield-compact through the first ``log_m - expand_nvars`` sumcheck
    rounds (``sumcheck.prove_host_bigm``), and the arena's f-hat table is
    freed in the sumcheck. Without it (the standard path) they are stacked
    from ``w_s`` and expanded. Both give the same proof.

    ``w_s`` is consumed: each witness's ``f_coeff`` table is dead from here
    on and is freed on entry (``f`` and ``f_hat`` stay valid)."""
    ring = ccs.ring
    ccs.sanity_check(dp.L)
    if len(cm_i_s) != 2 * dp.K:
        raise FoldingError("expected 2K instances")
    log_m = ccs.s
    dev = z_s[0].device

    for w in w_s:
        w.f_coeff = None

    alpha_s, beta_s, zeta_s, mu_s = squeeze_alpha_beta_zeta_mu(ring, transcript, dp, log_m)

    if arena is not None:
        f_hat_all = arena.fhat  # [2K, tau, m, ...]
    else:
        f_hat_all = torch.stack([w.f_hat for w in w_s])
    z_all = torch.stack(z_s)  # [2K, ncols, ...]

    r_first, r_second = cm_i_s[0].r, cm_i_s[dp.K].r
    eq1 = mlemod.build_eq(ring, mlemod.point_to_device(ring, r_first, dev))
    eq2 = mlemod.build_eq(ring, mlemod.point_to_device(ring, r_second, dev))
    beta_eq = mlemod.build_eq(ring, mlemod.point_to_device(ring, beta_s, dev))
    alphas = mlemod.point_to_device(ring, alpha_s, dev)
    zetas = mlemod.point_to_device(ring, zeta_s, dev)
    mus = mlemod.point_to_device(ring, mu_s, dev)

    comb = _folding_comb(ring, 2 * dp.K, ring.tau, dp.b, dev)
    degree = 2 * dp.b

    if arena is not None:
        full5 = [prepare_folding_parts_grouped(
            ring, dp.K, f_hat_all, z_all, ccs, eq1, eq2, beta_eq, alphas, zetas
        )]
        # the five rows and the compact table go to the sumcheck in boxes,
        # with no other reference left: it drops the rows as it folds them
        # and frees the table after the round-J expansion
        fhat_box = [f_hat_all]
        f_hat_all = arena.fhat = None
        del eq1, eq2, beta_eq
        proof_sc, r_0, final_vals = sc.prove_host_bigm(
            ring, transcript, full5.pop(), fhat_box, log_m, degree, comb, mus, expand_nvars=expand_nvars
        )
    else:
        mles = prepare_folding_mles_streaming(
            ring, dp.K, f_hat_all, z_all, ccs, eq1, eq2, beta_eq, alphas, zetas
        )
        del f_hat_all, eq1, eq2, beta_eq
        proof_sc, r_0, final_vals = sc.prove(ring, transcript, mles, log_m, degree, comb, mus)
        del mles

    # thetas come free from the final folded tables (f_hat rows are mles[5:])
    fhat_finals = rops.to_host(ring, final_vals[5:])
    theta_s = [
        [fhat_finals[i * ring.tau + j] for j in range(ring.tau)]
        for i in range(2 * dp.K)
    ]
    # etas by the transpose trick: mle[M_j z](r_0) = <z, M_j^T eq_{r_0}>
    eq_r0 = mlemod.build_eq(ring, mlemod.point_to_device(ring, r_0, dev))
    wT = torch.stack([M.transpose().mat_vec(eq_r0) for M in ccs.M])  # [t, ncols, ...]
    etas_host = rops.to_host(ring, _eta_dots(ring, z_all, wT))
    eta_s = [list(etas_host[i]) for i in range(2 * dp.K)]

    for thetas in theta_s:
        transcript.absorb_slice(thetas)
    for etas in eta_s:
        transcript.absorb_slice(etas)

    rho_coeff_s, rho_ntt_s = get_rhos(ring, transcript, dp)

    rhos = rops.to_device(ring, rho_ntt_s, dev)
    if arena is not None:
        f_0 = fold_witnesses_stream(ring, arena.f, rhos)
        arena.f = None
    else:
        f_all = torch.stack([w.f for w in w_s])
        f_0 = fold_witnesses(ring, f_all, rhos)
        del f_all

    v_0, cm_0, u_0, x_0 = compute_v0_u0_x0_cm0(
        ring, rho_coeff_s, rho_ntt_s, theta_s, cm_i_s, eta_s, ccs
    )
    h = x_0[-1]
    lcccs = LCCCS(r=r_0, v=v_0, cm=cm_0, u=u_0, x_w=x_0[:-1], h=h)
    w_0 = Witness.from_f(ring, dp, f_0, ccs.m)
    proof = FoldingProof(sumcheck=proof_sc, theta_s=theta_s, eta_s=eta_s)
    return lcccs, w_0, proof


def verify(
    cm_i_s: List[LCCCS],
    proof: FoldingProof,
    transcript: Transcript,
    ccs: CCS,
    dp: DecompositionParams,
):
    ring = ccs.ring
    ccs.sanity_check(dp.L)

    alpha_s, beta_s, zeta_s, mu_s = squeeze_alpha_beta_zeta_mu(ring, transcript, dp, ccs.s)
    claim_g1, claim_g3 = calculate_claims(ring, alpha_s, zeta_s, cm_i_s)

    r_0, expected = sc.verify(
        ring, transcript, ccs.s, 2 * dp.b, ring.radd(claim_g1, claim_g3), proof.sumcheck
    )

    e_ast = sc.eq_eval(ring, beta_s, r_0)
    e_s = [sc.eq_eval(ring, cm_i.r, r_0) for cm_i in cm_i_s]
    should_equal = expected_evaluation(
        ring, dp, alpha_s, mu_s, proof.theta_s, e_ast, e_s, zeta_s, proof.eta_s
    )
    if should_equal != expected:
        raise FoldingError("sumcheck claim mismatch")

    for thetas in proof.theta_s:
        transcript.absorb_slice(thetas)
    for etas in proof.eta_s:
        transcript.absorb_slice(etas)

    rho_coeff_s, rho_ntt_s = get_rhos(ring, transcript, dp)
    v_0, cm_0, u_0, x_0 = compute_v0_u0_x0_cm0(
        ring, rho_coeff_s, rho_ntt_s, proof.theta_s, cm_i_s, proof.eta_s, ccs
    )
    h = x_0[-1]
    return LCCCS(r=r_0, v=v_0, cm=cm_0, u=u_0, x_w=x_0[:-1], h=h)
