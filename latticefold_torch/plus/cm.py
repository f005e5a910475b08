"""Commitment transformation (LatticeFold+ Construction 4.5).

Port of the reference's cm.rs semantics: turn the double commitments of the
range check into foldable linear commitments. Short challenges s (3) and s'
(k x d) (cm.rs:69-80); h = sum_i M_f_i s'_i and comh = sum_i comM_f_i s'_i
(cm.rs:82-126); tensor-structured t(z) = tensor(c) (x) s' (x) (d'^i) (x)
(X^i) (cm.rs:597-606); two degree-2 batched sumchecks over {eq, tau, m_tau,
f, h, M*each, t0, t1} with an rc-power combiner (cm.rs:201-342 / verifier
349-538); folded witness g = s0 tau + s1 m_tau + s2 f + h (cm.rs:167-183).

Tensors: h is a monomial gather, a ring product and a sum over the d
columns, a chunk of rows at a time; the ring MLE stack (1 + L(4+4|M|) + 2
tables of size n, written in place into one tensor) runs through the
scalar-challenge ring sumcheck (plus/sumcheck.py); openings are
scalar-weighted contractions. comh, t(z) and the claim recomputation are
small host coefficient algebra.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import modops as mo
from ..arith.sparse import SparseMatrix
from ..rings import ops as rops
from ..rings.construct import Ring
from . import coeffring as cr
from . import mleops
from . import sumcheck as psc
from .rgchk import Dcom, Rg, const_ring_batch, dcom_verify, scalar_to_ring_table
from .transcript import PlusTranscript

# rows of h taken at a time (each makes [rows, d, c, e, nl] ring products)
_H_ROWS = 1 << 13


@dataclass
class InstanceEvals:
    """[1 + len(M)] groups of [tau, m_tau, f, h] openings at ro
    (cm.rs:28-29, 316-337); coefficient-form ring elements."""

    groups: List[List[list]]


@dataclass
class CmProof:
    dcom: Dcom
    comh: List[List[list]]  # [L][kappa] coeff lists
    sumcheck_proofs: Tuple[psc.SumcheckProof, psc.SumcheckProof]
    evals: Tuple[List[InstanceEvals], List[InstanceEvals]]


@dataclass
class ComX:
    cm_g: List[List[list]]  # [L][kappa]
    ro: List[Tuple[int, int]]  # paired sumcheck points (F_q ints)
    vo: List[List[Tuple[list, list]]]  # [L][1+len(M)] coeff-list pairs


@dataclass
class Com:
    g: List[torch.Tensor]  # [L] witnesses [n, ncomp, e, nl]
    x: ComX


class CmError(Exception):
    pass


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _tensor_scalars(q: int, cz: List[int]) -> List[int]:
    """tensor(c): the 2^len(c) products of (1 - c_i) or c_i; the last c_i
    takes the lowest index bit."""
    tc = [1]
    for ci in cz:
        tc = [y for x in tc for y in (x * ((1 - ci) % q) % q, x * ci % q)]
    return tc


def calculate_t_z(ring: Ring, c_z: List[int], s_prime_flat: List[list], l: int) -> np.ndarray:
    """t(z) = tensor(c) (x) s'_flat (x) (1, d', .., d'^(l-1)) (x) (1, X, ..,
    X^(d-1)) (cm.rs:597-606): host coefficients, an object array [N, d].
    The product by the monomial X^i is a negacyclic shift by i."""
    q, d = ring.q, ring.d
    dpp = [pow(d // 2, i, q) for i in range(l)]
    scal = np.array([[t * dpi % q for dpi in dpp] for t in _tensor_scalars(q, c_z)], dtype=object)  # [T, l]
    s = np.array(s_prime_flat, dtype=object)  # [S, d]
    p = scal[:, None, :, None] * s[None, :, None, :] % q  # [T, S, l, d]
    out = np.empty(p.shape[:3] + (d, d), dtype=object)  # [T, S, l, X^i, coeff]
    for i in range(d):
        out[..., i, i:] = p[..., : d - i]
        out[..., i, :i] = (-p[..., d - i :]) % q
    return out.reshape(-1, d)


def _h_vectors(ring: Ring, rg: Rg, s_prime_ntt) -> List[torch.Tensor]:
    """h_l = sum_i M_f_i s'_i (cm.rs:82-103): monomial gather, ring product
    with s' [d, ...] (broadcast over rows), sum over the d columns; a chunk
    of _H_ROWS rows at a time, so the [rows, d, c, e, nl] products stay
    bounded."""
    mono = cr.monomial_table(ring, s_prime_ntt.device)
    out = []
    for inst in rg.instances:
        n = inst.D_idx.shape[1]
        h = inst.f_ntt.new_empty((n, ring.ncomp, ring.e, ring.nl))
        for lo in range(0, n, _H_ROWS):
            acc = None
            for kk in range(rg.dparams.k):
                prod = rops.ring_mul(ring, mono[inst.D_idx[kk, lo : lo + _H_ROWS]], s_prime_ntt[kk][None])
                s = rops.ring_sum(ring, prod, 1)  # [rows, c, e, nl]
                del prod
                acc = s if acc is None else rops.ring_add(ring, acc, s)
            h[lo : lo + _H_ROWS] = acc
        out.append(h)
    return out


def _comh(ring: Ring, rg: Rg, s_prime_coeff) -> List[List[list]]:
    """comh_l = sum_i comM_f_i s'_i (cm.rs:105-125), host coefficient algebra."""
    out = []
    for inst in rg.instances:
        kappa = len(inst.comM_f[0])
        acc = [cr.czero(ring) for _ in range(kappa)]
        for kk, Mi in enumerate(inst.comM_f):
            for i in range(kappa):
                for j in range(ring.d):
                    acc[i] = cr.cadd(ring, acc[i], cr.cmul(ring, Mi[i][j], s_prime_coeff[kk][j]))
        out.append(acc)
    return out


def _cm_comb(ring: Ring, L: int, Mlen: int) -> psc.CombFn:
    """comb_fn (cm.rs:285-306), degree 2: sum over instances l of
    eq * (sum_o rc^(l blk + o) g_(l, o)) + tau_l * (rc^z t0 + rc^(z+1) t1),
    with blk = 4 + 4|M| tables g per instance, tau_l its first. Taken in
    tensor ops over every instance and table at once, with the ring
    products gathered by bilinearity (sum_l eq x_l = eq sum_l x_l): every
    value is exact mod q, so it equals the term-by-term sum."""
    m = ring.fq
    blk = 4 + 4 * Mlen
    z_idx = L * blk

    def fn(vals, consts):
        (rcps,) = consts  # [L*blk + 2, nl]
        nm = vals.shape[0]
        tabs = vals[1 : 1 + z_idx].reshape((L, blk) + tuple(vals.shape[1:]))  # [L, blk, M, c, e, nl]
        w = rcps[:z_idx].reshape(L, blk, 1, 1, 1, m.nl)
        inner = mo.sum_mod(m, mo.sum_mod(m, mo.mont_mul(m, tabs, w), 1), 0)  # [M, c, e, nl]
        t = mo.add(m, mo.mont_mul(m, vals[nm - 2], rcps[z_idx]), mo.mont_mul(m, vals[nm - 1], rcps[z_idx + 1]))
        tau = mo.sum_mod(m, tabs[:, 0], 0)
        return mo.add(m, rops.ext_mul(ring, vals[0], inner), rops.ext_mul(ring, tau, t))

    return psc.CombFn(fn, scalar=False)


def _build_cm_mles(ring: Ring, rg: Rg, r: List[int], h, t_dev_pair, M) -> torch.Tensor:
    """[1 + L(4+4|M|) + 2, n, c, e, nl] stack (cm.rs:216-260), written
    table by table into one tensor: no table is held twice."""
    dev = h[0].device
    n = h[0].shape[0]
    L = len(rg.instances)
    mono = cr.monomial_table(ring, dev)
    mles = h[0].new_empty((1 + L * (4 + 4 * len(M)) + 2, n, ring.ncomp, ring.e, ring.nl))
    eq_scalar = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, r, dev))
    mles[0] = scalar_to_ring_table(ring, eq_scalar)
    del eq_scalar
    i = 1
    for li, inst in enumerate(rg.instances):
        group = mles[i : i + 4]  # tau, m_tau, f, h
        group[0] = const_ring_batch(ring, inst.tau)
        group[1] = mono[inst.m_tau_idx]
        group[2] = inst.f_ntt
        group[3] = h[li]
        i += 4
        for Mi in M:
            Mi.mat_vec_batched(group, out=mles[i : i + 4])
            i += 4
    mles[i], mles[i + 1] = t_dev_pair
    return mles


def _rc_powers(ring: Ring, rc: int, n: int, device) -> torch.Tensor:
    q = ring.q
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * rc % q
    return mleops.scalars_dev(ring, pows, device)


def _open_stack(ring: Ring, mles, ro: List[int]):
    """Evaluate every stacked ring MLE at the scalar point ro."""
    eq = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, ro, mles.device))
    vals = mleops.eval_ring_mles_scalar(ring, mles, eq)
    return [ring.icrt_host(h) for h in rops.to_host(ring, vals)]


def _sumchecker(ring: Ring, rg: Rg, mles, M, transcript: PlusTranscript):
    """cm.rs:201-342: one rc-batched degree-2 sumcheck + openings."""
    L = len(rg.instances)
    Mlen = len(M)
    blk = 4 + 4 * Mlen

    rc = transcript.get_challenge()
    consts = (_rc_powers(ring, rc, L * blk + 2, mles.device),)
    proof, ro, _ = psc.prove(ring, transcript, mles, rg.nvars, 2, _cm_comb(ring, L, Mlen), consts)

    opened = _open_stack(ring, mles, ro)
    evals = []
    for li in range(L):
        l_idx = 1 + li * blk
        groups = [opened[l_idx : l_idx + 4]]
        for i in range(Mlen):
            idx = l_idx + 4 + 4 * i
            groups.append(opened[idx : idx + 4])
        evals.append(InstanceEvals(groups=groups))

    _absorb_evals(ring, evals, transcript)
    return proof, evals, ro


def _absorb_evals(ring: Ring, evals: List[InstanceEvals], transcript: PlusTranscript):
    """cm.rs:586-595."""
    for iev in evals:
        for grp in iev.groups:
            transcript.absorb_coeffs_slice(grp)


def _coeff_rows_to_ntt(ring: Ring, rows: np.ndarray, n: int, device) -> torch.Tensor:
    """Coefficient rows [N, d] (host ints) -> NTT-form ring table [n, c, e,
    nl] (Montgomery), zero past N: the CRT matrix applied on the host (the
    JAX package's ``crt_host`` per element), the Montgomery scale on the
    device."""
    flat = rows.dot(np.array(ring.crt_rows, dtype=object).T) % ring.q  # [N, d]
    out = mo.to_mont(ring.fq, mleops.canonical_tensor(ring, flat, device))
    out = torch.cat([out, out.new_zeros((n - out.shape[0], ring.d, ring.nl))])
    return out.reshape(n, ring.ncomp, ring.e, ring.nl)


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def cm_prove(rg: Rg, M: Sequence[SparseMatrix], transcript: PlusTranscript) -> Tuple[Com, CmProof]:
    """cm.rs:56-199."""
    ring = rg.instances[0].ring
    dev = rg.instances[0].f_ntt.device
    d = ring.d
    k, l = rg.dparams.k, rg.dparams.l
    n = rg.instances[0].f_ntt.shape[0]

    dcom = rg.range_check(M, transcript)

    s_coeff = [transcript.short_challenge() for _ in range(3)]
    s_prime_coeff = [[transcript.short_challenge() for _ in range(d)] for _ in range(k)]
    s_prime_flat = [x for row in s_prime_coeff for x in row]
    s_prime_ntt = rops.to_device(ring, [[ring.crt_host(c) for c in row] for row in s_prime_coeff], dev)

    h = _h_vectors(ring, rg, s_prime_ntt)
    comh = _comh(ring, rg, s_prime_coeff)
    for ci in comh:
        transcript.absorb_coeffs_slice(ci)

    kappa = len(comh[0])
    log_kappa = (kappa - 1).bit_length() if kappa > 1 else 0
    c = [transcript.get_challenges(log_kappa) for _ in range(2)]

    t_dev = []
    for cz in c:
        t = calculate_t_z(ring, cz, s_prime_flat, l)
        if len(t) > n:
            raise CmError(f"t(z) length {len(t)} > witness length {n}")
        t_dev.append(_coeff_rows_to_ntt(ring, t, n, dev))

    mles = _build_cm_mles(ring, rg, dcom.out.r, h, t_dev, M)
    del t_dev

    proof_a, evals_a, ro_a = _sumchecker(ring, rg, mles, M, transcript)
    proof_b, evals_b, ro_b = _sumchecker(ring, rg, mles, M, transcript)
    del mles

    # Step 7: g = s0 tau + s1 m_tau + s2 f + h (cm.rs:167-183)
    s_ntt = rops.to_device(ring, [ring.crt_host(cc) for cc in s_coeff], dev)
    mono = cr.monomial_table(ring, dev)
    g = []
    for li, inst in enumerate(rg.instances):
        gi = rops.ring_mul(ring, const_ring_batch(ring, inst.tau), s_ntt[0][None])
        gi = rops.ring_add(ring, gi, rops.ring_mul(ring, mono[inst.m_tau_idx], s_ntt[1][None]))
        gi = rops.ring_add(ring, gi, rops.ring_mul(ring, inst.f_ntt, s_ntt[2][None]))
        g.append(rops.ring_add(ring, gi, h[li]))

    proof = CmProof(dcom=dcom, comh=comh, sumcheck_proofs=(proof_a, proof_b), evals=(evals_a, evals_b))
    ro = list(zip(ro_a, ro_b))
    return Com(g=g, x=proof_x(ring, proof, s_coeff, ro)), proof


def proof_x(ring: Ring, proof: CmProof, s: List[list], ro) -> ComX:
    """CmProof::x (cm.rs:540-579)."""
    def fold3(g):
        v = cr.cmul(ring, s[0], g[0])
        v = cr.cadd(ring, v, cr.cmul(ring, s[1], g[1]))
        v = cr.cadd(ring, v, cr.cmul(ring, s[2], g[2]))
        return cr.cadd(ring, v, g[3])

    cm_g = []
    for li, fc in enumerate(proof.dcom.fcoms):
        cm_g.append([fold3((fc.C_Mf[i], fc.cm_mtau[i], fc.cm_f[i], proof.comh[li][i]))
                     for i in range(len(fc.cm_f))])
    vo = []
    for e0, e1 in zip(proof.evals[0], proof.evals[1]):
        vo.append([(fold3(g0), fold3(g1)) for g0, g1 in zip(e0.groups, e1.groups)])
    return ComX(cm_g=cm_g, ro=ro, vo=vo)


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def cm_verify(ring: Ring, proof: CmProof, M: Sequence[SparseMatrix], transcript: PlusTranscript) -> ComX:
    """cm.rs:349-538."""
    q, d = ring.q, ring.d
    k, l = proof.dcom.dparams.k, proof.dcom.dparams.l
    L = len(proof.evals[0])
    Mlen = len(M)
    blk = 4 + 4 * Mlen
    nvars = proof.dcom.out.nvars

    dcom_verify(ring, proof.dcom, transcript)

    s_coeff = [transcript.short_challenge() for _ in range(3)]
    s_prime_coeff = [[transcript.short_challenge() for _ in range(d)] for _ in range(k)]
    s_prime_flat = [x for row in s_prime_coeff for x in row]

    for ci in proof.comh:
        transcript.absorb_coeffs_slice(ci)

    kappa = len(proof.comh[0])
    log_kappa = (kappa - 1).bit_length() if kappa > 1 else 0
    c = [transcript.get_challenges(log_kappa) for _ in range(2)]

    # u[l][ni] = sum over instance-l set openings * s' (cm.rs:389-406)
    u = []
    for l_i in range(L):
        row = []
        for e_ni in proof.dcom.out.e:
            acc = cr.czero(ring)
            flat_idx = 0
            for eset in e_ni[k * l_i : k * l_i + k]:
                for ej in eset:
                    acc = cr.cadd(ring, acc, cr.cmul(ring, ej, s_prime_flat[flat_idx]))
                    flat_idx += 1
            row.append(acc)
        u.append(row)

    # tensor contractions of comh (cm.rs:408-431)
    tcch = [[_lin_comb_scalar(ring, _tensor_scalars(q, cz), proof.comh[l_i]) for l_i in range(L)] for cz in c]
    # t0, t1 (cm.rs:483-492), evaluated at each sumcheck's point below
    t_tabs = [calculate_t_z(ring, cz, s_prime_flat, l) for cz in c]

    ros = []
    for sc_i in range(2):
        rc = transcript.get_challenge()
        rcp = [1] * (L * blk + 2)
        for i in range(1, len(rcp)):
            rcp[i] = rcp[i - 1] * rc % q

        claimed = cr.czero(ring)
        z_idx = L * blk
        for l_i, ev in enumerate(proof.dcom.evals):
            l_idx = l_i * blk
            term = cr.cconst(ring, ev.a[0] * rcp[l_idx] % q)
            term = cr.cadd(ring, term, cr.cscale(ring, rcp[l_idx + 1], ev.b[0]))
            term = cr.cadd(ring, term, cr.cscale(ring, rcp[l_idx + 2], ev.c[0]))
            term = cr.cadd(ring, term, cr.cscale(ring, rcp[l_idx + 3], u[l_i][0]))
            for i in range(Mlen):
                idx = l_idx + 4 + i * 4
                term = cr.cadd(ring, term, cr.cconst(ring, ev.a[1 + i] * rcp[idx] % q))
                term = cr.cadd(ring, term, cr.cscale(ring, rcp[idx + 1], ev.b[1 + i]))
                term = cr.cadd(ring, term, cr.cscale(ring, rcp[idx + 2], ev.c[1 + i]))
                term = cr.cadd(ring, term, cr.cscale(ring, rcp[idx + 3], u[l_i][1 + i]))
            term = cr.cadd(ring, term, cr.cscale(ring, rcp[z_idx], tcch[0][l_i]))
            term = cr.cadd(ring, term, cr.cscale(ring, rcp[z_idx + 1], tcch[1][l_i]))
            claimed = cr.cadd(ring, claimed, term)

        ro, expected = psc.verify(ring, transcript, nvars, 2, claimed, proof.sumcheck_proofs[sc_i])
        t_ro = [_coeff_mle_eval(ring, tab, ro) for tab in t_tabs]

        evals = proof.evals[sc_i]
        _absorb_evals(ring, evals, transcript)

        eqv = psc.eq_eval_scalar(ring, proof.dcom.out.r, ro)
        total = cr.czero(ring)
        for l_i, iev in enumerate(evals):
            l_idx = l_i * blk
            inner = cr.czero(ring)
            for gi, grp in enumerate(iev.groups):
                base = l_idx + (0 if gi == 0 else 4 + (gi - 1) * 4)
                for o in range(4):
                    inner = cr.cadd(ring, inner, cr.cscale(ring, rcp[base + o], grp[o]))
            term = cr.cscale(ring, eqv, inner)
            tau_eval = iev.groups[0][0]
            term = cr.cadd(ring, term, cr.cscale(ring, rcp[z_idx], cr.cmul(ring, t_ro[0], tau_eval)))
            term = cr.cadd(ring, term, cr.cscale(ring, rcp[z_idx + 1], cr.cmul(ring, t_ro[1], tau_eval)))
            total = cr.cadd(ring, total, term)

        if total != list(expected):
            raise CmError(f"cm sumcheck {sc_i} claim mismatch")
        ros.append(ro)

    ro = list(zip(ros[0], ros[1]))
    return proof_x(ring, proof, s_coeff, ro)


def _lin_comb_scalar(ring: Ring, scalars: List[int], elts: List[list]) -> list:
    acc = cr.czero(ring)
    for s, e in zip(scalars, elts):
        acc = cr.cadd(ring, acc, cr.cscale(ring, s, e))
    return acc


def _coeff_mle_eval(ring: Ring, table: np.ndarray, point: List[int]) -> list:
    """MLE eval of a short coefficient table [N, d] (host ints) at a scalar
    point, zero past N (host)."""
    q = ring.q
    vals = np.zeros((1 << len(point), ring.d), dtype=object)
    vals[: len(table)] = table
    for r in point:
        a, b = vals[0::2], vals[1::2]
        vals = (a + r * ((b - a) % q)) % q
    return [int(v) for v in vals[0]]
