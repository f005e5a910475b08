"""Range check via double commitments (LatticeFold+ Constructions 4.3-4.4).

Port of the reference's rgchk.rs semantics: ``RgInstance.from_f``
(rgchk.rs:260-332) decomposes cf(f) into k balanced base-b digit matrices
D_f, maps digits to monomials (EXP), commits the monomial matrices
column-wise (comM_f = A * M_f, one batch commit), gadget-splits the
concatenated commitment into tau (utils.rs:12-41), sets m_tau = EXP(tau),
and commits cm_f / C_Mf / cm_mtau (a second batch commit). ``range_check``
(rgchk.rs:81-186) runs the monomial set check over {M_f..., m_tau...} and
opens the tau/m_tau/f MLEs (plus their M_i-multiplied variants) at the set
check's point; the verifier (rgchk.rs:193-241) checks the psi-based
constant-term identities ct(psi*b) = a and ct(psi * sum d'^i u_i) = v.

Layout: digits, monomial exponents and tau are int64 tensors on the
witness's device; the commits go through ``AjtaiScheme.commit_batch``,
the monomial columns in groups of at most 4 GiB; MLE
openings are scalar-weighted contractions (plus/mleops.py). The split
of the commitment into tau is host code, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from .. import modops as mo
from ..arith.sparse import SparseMatrix
from ..commitment import AjtaiScheme
from ..rings import ops as rops
from ..rings.construct import Ring
from . import coeffring as cr
from . import mleops
from .setchk import MatrixSet, SetCheckOut, VectorSet, _bucket_dev, set_check
from .setchk import verify as setchk_verify
from .transcript import PlusTranscript

# bytes of the monomial columns gathered for one batch commit of from_f
_MF_GROUP_BYTES = 1 << 32


@dataclass(frozen=True)
class DecompParameters:
    """b: digit base (= d' = d/2 in all shipped configs); k: digit count;
    l: log_{d'}(q) (rgchk.rs:20-24)."""

    b: int
    k: int
    l: int


@dataclass
class FComs:
    """cm_f, C_Mf, cm_mtau: kappa coefficient-form ring elements each
    (rgchk.rs:27-31)."""

    cm_f: List[list]
    C_Mf: List[list]
    cm_mtau: List[list]


@dataclass
class RgInstance:
    ring: Ring
    f_ntt: torch.Tensor  # [n, ncomp, e, nl]
    f_coeff_mont: torch.Tensor  # [n, d, nl] Montgomery
    D_idx: torch.Tensor  # [k, n, d] int64 EXP indices of the digit matrices
    tau: torch.Tensor  # [n] int64 signed digits (tau mod q is the F_q value)
    m_tau_idx: torch.Tensor  # [n] int64
    comM_f: List[List[List[list]]]  # [k][kappa][d] coeff lists
    fcoms: FComs

    @classmethod
    def from_f(cls, ring: Ring, f_ntt, scheme: AjtaiScheme, dparams: DecompParameters) -> "RgInstance":
        cr.require_power2(ring)
        n, d = f_ntt.shape[0], ring.d
        k, l, b = dparams.k, dparams.l, dparams.b
        dev = f_ntt.device

        f_coeff = mo.from_mont(ring.fq, rops.icrt(ring, f_ntt))  # [n, d, nl]
        digs = mo.signed_digits(ring.fq, f_coeff, b, k)  # [n, d, k]
        D_idx = (digs % d).permute(2, 0, 1).contiguous()  # [k, n, d]

        # batched commits of the k*d monomial columns, mf_group_cols at a
        # time (a commit is column by column: the groups' outputs side by
        # side are the one batch's)
        mono = cr.monomial_table(ring, dev)  # [d, c, e, nl]
        cols = D_idx.permute(1, 0, 2).reshape(n, k * d)
        g = mf_group_cols(ring, n)
        comMf = torch.cat([scheme.commit_batch(mono[cols[:, lo : lo + g]]) for lo in range(0, k * d, g)], dim=1)
        comMf_host = rops.to_host(ring, comMf)  # [kappa, k*d] ring elts
        del cols, comMf
        kappa = scheme.kappa
        # comM_f[kk][i][j]: commitment row i, monomial-matrix kk, column j
        comM_f = [
            [[ring.icrt_host(comMf_host[i, kk * d + j]) for j in range(d)] for i in range(kappa)]
            for kk in range(k)
        ]

        tau_signed = split(ring, comM_f, b, l, n)
        tau = torch.tensor(tau_signed, dtype=torch.int64, device=dev)
        m_tau_idx = tau % d

        rest = torch.stack([f_ntt, const_ring_batch(ring, tau), mono[m_tau_idx]], dim=1)  # [n, 3, ...]
        coms_host = rops.to_host(ring, scheme.commit_batch(rest))  # [kappa, 3]
        fcoms = FComs(
            cm_f=[ring.icrt_host(coms_host[i, 0]) for i in range(kappa)],
            C_Mf=[ring.icrt_host(coms_host[i, 1]) for i in range(kappa)],
            cm_mtau=[ring.icrt_host(coms_host[i, 2]) for i in range(kappa)],
        )

        return cls(
            ring=ring,
            f_ntt=f_ntt,
            f_coeff_mont=mo.to_mont(ring.fq, f_coeff),
            D_idx=D_idx,
            tau=tau,
            m_tau_idx=m_tau_idx,
            comM_f=comM_f,
            fcoms=fcoms,
        )


def mf_group_cols(ring: Ring, n: int) -> int:
    """Monomial columns [n, cols, c, e, nl] per batch commit of ``from_f``:
    as many as fit _MF_GROUP_BYTES (at least one)."""
    return max(1, _MF_GROUP_BYTES // (n * ring.d * ring.nl * 8))


def split(ring: Ring, comM_f, b: int, l: int, n: int) -> List[int]:
    """split (utils.rs:12-41): gadget-decompose the hconcat'ed commitment
    row-major (row, then column, then digit, then coefficient) into signed
    base-b digits, padded with zeros to n. Host code."""
    q, d = ring.q, ring.d
    k, kappa = len(comM_f), len(comM_f[0])
    tau: List[int] = []
    for i in range(kappa):
        for kk in range(k):
            for j in range(d):
                digs_e = [_host_balanced_digits(q, c, b, l) for c in comM_f[kk][i][j]]  # [d][l]
                for t in range(l):
                    for c in range(d):
                        tau.append(digs_e[c][t])
    if len(tau) > n:
        raise ValueError(f"split: tau length {len(tau)} > n {n}")
    return tau + [0] * (n - len(tau))


def _host_balanced_digits(q: int, x: int, base: int, nd: int) -> List[int]:
    s = int(x) if int(x) <= q // 2 else int(x) - q
    neg, mag = s < 0, abs(s)
    out = []
    for _ in range(nd):
        r = mag % base
        quo = mag // base
        if 2 * r > base:
            r -= base
            quo += 1
        out.append(-r if neg else r)
        mag = quo
    if mag:
        raise ValueError("split: value does not fit l digits")
    return out


def const_ring_batch(ring: Ring, digits) -> torch.Tensor:
    """Small signed integers [n] -> diagonal (constant) NTT ring elements
    [n, c, e, nl] (Montgomery)."""
    mont = mo.to_mont(ring.fq, mo.digits_to_field(ring.fq, digits))  # [n, nl]
    return scalar_to_ring_table(ring, mont)


def scalar_to_ring_table(ring: Ring, scalars_mont) -> torch.Tensor:
    """Scalar table [n, nl] -> constant-embedded ring table [n, c, e, nl]."""
    n = scalars_mont.shape[0]
    out = scalars_mont.new_zeros((n, ring.ncomp, ring.e, ring.nl))
    out[:, :, 0, :] = scalars_mont[:, None, :]
    return out


@dataclass
class DcomEvals:
    """v, a: F_q scalars; b, c: coefficient-form ring elements (rgchk.rs:58-64)."""

    v: List[int]
    a: List[int]
    b: List[list]
    c: List[list]


@dataclass
class Dcom:
    evals: List[DcomEvals]
    fcoms: List[FComs]
    out: SetCheckOut
    dparams: DecompParameters


class RangeCheckError(Exception):
    pass


@dataclass
class Rg:
    nvars: int
    instances: List[RgInstance]
    dparams: DecompParameters

    def range_check(self, M: Sequence[SparseMatrix], transcript: PlusTranscript) -> Dcom:
        """rgchk.rs:81-186."""
        ring = self.instances[0].ring
        dev = self.instances[0].f_ntt.device
        sets = []
        for inst in self.instances:
            sets.extend(MatrixSet(idx=inst.D_idx[kk]) for kk in range(self.dparams.k))
        for inst in self.instances:
            sets.append(VectorSet(idx=inst.m_tau_idx))

        out = set_check(ring, self.nvars, sets, M, transcript, dev)

        eq_r = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, out.r, dev))
        w_host = mleops.host_ints(ring, eq_r)

        # u = M_i^T tensor(r), the same for every instance (host loops over n)
        n = self.instances[0].f_ntt.shape[0]
        u_devs = []
        for Mi in M:
            u = Mi.transpose_mul_scalar_host(ring, w_host[: Mi.nrows])[:n]
            u_devs.append(mleops.scalars_dev(ring, u + [0] * (n - len(u)), dev))

        evals = []
        for li, inst in enumerate(self.instances):
            tau_mont = mo.to_mont(ring.fq, mo.digits_to_field(ring.fq, inst.tau))[None]  # [1, n, nl]
            # v: per-coefficient MLE evals of cf(f) at r
            v = mleops.host_ints(ring, mleops.eval_scalar_mles(ring, inst.f_coeff_mont.transpose(0, 1), eq_r))

            # plain (no M) entries; a is <tensor(r), tau>
            a = [mleops.host_ints(ring, mleops.eval_scalar_mles(ring, tau_mont, eq_r))[0]]
            b = [out.b[li]]
            c = [_ring_eval(ring, inst.f_ntt, eq_r)]

            for Mi, u_dev in zip(M, u_devs):
                # a: ct(eval of M_i * tau) -- tau is scalar, so ct == value
                a.append(mleops.host_ints(ring, mleops.eval_scalar_mles(ring, tau_mont, u_dev))[0])
                # b: eval of M_i * m_tau (ring), via exponent buckets
                b.append([int(x) for x in _bucket_dev(ring, inst.m_tau_idx, u_dev)])
                # c: eval of M_i * f (ring)
                c.append(_ring_eval(ring, inst.f_ntt, u_dev))

            evals.append(DcomEvals(v=v, a=a, b=b, c=c))

        _absorb_evaluations(ring, evals, transcript)

        return Dcom(evals=evals, fcoms=[inst.fcoms for inst in self.instances], out=out, dparams=self.dparams)


def _ring_eval(ring: Ring, table, w) -> list:
    """sum_x w[x] table[x] for a ring table [n, c, e, nl], as a coefficient list."""
    val = mleops.eval_ring_mles_scalar(ring, table[None], w)[0]
    return ring.icrt_host(rops.to_host(ring, val))


def _absorb_evaluations(ring: Ring, evals: List[DcomEvals], transcript: PlusTranscript):
    """rgchk.rs:335-340: absorb a (as constants) then c, per instance."""
    for ev in evals:
        for ai in ev.a:
            transcript.absorb_coeffs(cr.cconst(ring, ai))
        for ci in ev.c:
            transcript.absorb_coeffs(ci)


def dcom_verify(ring: Ring, dcom: Dcom, transcript: PlusTranscript):
    """rgchk.rs:193-241."""
    setchk_verify(ring, dcom.out, transcript)
    _absorb_evaluations(ring, dcom.evals, transcript)

    q, d = ring.q, ring.d
    dp = d // 2
    psi = list(cr.psi_coeffs(ring))
    k = dcom.dparams.k

    for li, ev in enumerate(dcom.evals):
        # ct(psi * b) == a
        for a_i, b_i in zip(ev.a, ev.b):
            if cr.ct(cr.cmul(ring, psi, b_i)) != a_i % q:
                raise RangeCheckError(f"psi check a/b failed (instance {li})")

        for ni in range(len(dcom.out.e)):
            u_sets = dcom.out.e[ni][k * li : k * li + k]
            u_comb = [cr.czero(ring) for _ in range(d)]
            dpow = 1
            for u_i in u_sets:
                for j in range(d):
                    u_comb[j] = cr.cadd(ring, u_comb[j], cr.cscale(ring, dpow, u_i[j]))
                dpow = dpow * dp % q
            v_rec = [cr.ct(cr.cmul(ring, psi, uc)) for uc in u_comb]
            if ni == 0:
                if v_rec != [x % q for x in ev.v]:
                    raise RangeCheckError(f"psi check v/u failed (instance {li})")
            else:
                if v_rec != [x % q for x in ev.c[ni]]:
                    raise RangeCheckError(f"psi check c/u failed (instance {li}, matrix {ni - 1})")
