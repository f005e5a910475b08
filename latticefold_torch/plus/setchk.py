"""Monomial set check (LatticeFold+ Construction 4.2).

Port of the reference's setchk.rs semantics: prove that matrices / vectors
consist of unit monomials X^m via the "ev(beta)^2 == ev(beta^2) iff
monomial" projection trick (setchk.rs:104-116, verifier 300-334).

Representation: a matrix set's entries are monomial *exponent* tensors
[n, ncols] (EXP index in [0, d); -1 encodes a zero entry, since the
reference's SparseMatrix leaves absent cells at R::zero). The ev-projected
MLEs are then pure F_q scalar tables built by a gather from the powers
table; the whole degree-3 sumcheck runs in the base field (d times cheaper
than a ring sumcheck). Dishonest/dense sets (negative tests) may supply
coefficient-form entries instead; those are ev'd on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import modops as mo
from ..arith.sparse import SparseMatrix
from ..device import resolve
from ..rings.construct import Ring
from . import coeffring as cr
from . import mleops
from . import sumcheck as psc
from .transcript import PlusTranscript

# F_q values (rows x columns x d exponents) per chunk of a bucket sum's rows
_BUCKET_VALUES = 1 << 23


@dataclass
class MatrixSet:
    """Monomial matrix: exponent indices [n, ncols] (integer tensor or
    array; -1 = zero entry), or coefficient-form entries [n, ncols, d]
    (numpy object array of host ints) for generic data."""

    idx: Optional[object] = None
    coeffs: Optional[np.ndarray] = None

    @property
    def shape(self):
        src = self.idx if self.idx is not None else self.coeffs[..., 0]
        return tuple(src.shape)


@dataclass
class VectorSet:
    idx: Optional[object] = None  # [n]
    coeffs: Optional[np.ndarray] = None  # [n, d] host ints


def _pw_dev(ring: Ring, beta: int, device) -> torch.Tensor:
    """[d, nl] Montgomery powers beta^0..beta^(d-1)."""
    q = ring.q
    return mleops.scalars_dev(ring, [pow(beta, i, q) for i in range(ring.d)], device)


def _ev_project_dev(ring: Ring, s, beta: int, n: int, device) -> torch.Tensor:
    """Entries -> [rows(s) padded to n, cols?, nl] F_q evals at beta
    (Montgomery). Monomial-index sets take a gather from the powers table;
    coefficient-form sets (dishonest-test data) are evaluated on the host."""
    q = ring.q
    if s.idx is not None:
        idx = torch.as_tensor(s.idx, device=device).long()
        vals = _pw_dev(ring, beta, device)[idx.clamp(min=0)]  # [..., nl]
        vals = torch.where((idx < 0)[..., None], torch.zeros_like(vals), vals)
    else:
        pw_h = [pow(beta, i, q) for i in range(ring.d)]
        acc = np.zeros(s.coeffs.shape[:-1], dtype=object)
        for i in range(ring.d):
            acc = (acc + s.coeffs[..., i] * pw_h[i]) % q
        vals = mo.to_mont(ring.fq, mleops.canonical_tensor(ring, acc, device))
    n0 = vals.shape[0]
    if n0 < n:
        vals = torch.cat([vals, vals.new_zeros((n - n0,) + tuple(vals.shape[1:]))])
    return vals


@dataclass
class SetCheckOut:
    """Out<R> (setchk.rs:30-36)."""

    nvars: int
    r: List[int]  # sumcheck point (F_q scalars)
    sumcheck_proof: psc.SumcheckProof
    e: List[List[List[list]]]  # [1+len(M)][nset_mat][ncols] coeff lists
    b: List[list]  # [nset_vec] coeff lists


class SetCheckError(Exception):
    pass


def _setchk_comb(ring: Ring, n_mat: int, ncols: int, n_vec: int, batched: bool) -> psc.CombFn:
    """comb_fn (setchk.rs:155-186): per matrix set i with MLE block
    [m_0, m'_0, .., m_{ncols-1}, m'_{ncols-1}, eq], res_i = eq * sum_j
    alpha_i^j (m_j^2 - m'_j); vector sets contribute eq * alpha * (m^2 - m').
    lc = sum_i rc^i res_i; without rc (a single set) only set 0 counts (the
    reference's early return, setchk.rs:166-183). Every set and column is
    taken in one tensor op: sums mod q are exact, so their order does not
    change a value."""
    m = ring.fq
    w = 2 * ncols + 1

    def fn(vals, consts):
        alpha_pows, rc_pows = consts  # [nsets, ncols, nl], [nsets, nl]
        res = []
        if n_mat:
            blk = vals[: n_mat * w].reshape((n_mat, w) + tuple(vals.shape[1:]))  # [n_mat, w, M, nl]
            mj, mp = blk[:, 0 : 2 * ncols : 2], blk[:, 1 : 2 * ncols : 2]  # [n_mat, ncols, M, nl]
            terms = mo.mont_mul(m, mo.sub(m, mo.mont_mul(m, mj, mj), mp), alpha_pows[:n_mat, :, None])
            res.append(mo.mont_mul(m, mo.sum_mod(m, terms, 1), blk[:, 2 * ncols]))
        if n_vec:
            vec = vals[n_mat * w :].reshape((n_vec, 3) + tuple(vals.shape[1:]))  # [n_vec, 3, M, nl]
            diff = mo.sub(m, mo.mont_mul(m, vec[:, 0], vec[:, 0]), vec[:, 1])
            res.append(mo.mont_mul(m, mo.mont_mul(m, diff, alpha_pows[n_mat:, 0, None]), vec[:, 2]))
        res = torch.cat(res)  # [nsets, M, nl]
        if not batched:
            return res[0]
        return mo.sum_mod(m, mo.mont_mul(m, res, rc_pows[:, None]), 0)

    return psc.CombFn(fn, scalar=True)


def set_check(
    ring: Ring,
    nvars: int,
    sets: Sequence[Union[MatrixSet, VectorSet]],
    M: Sequence[SparseMatrix],
    transcript: PlusTranscript,
    device=None,
) -> SetCheckOut:
    """Prover (setchk.rs:65-262). ``M`` are the linearization matrices whose
    M_i-multiplied column openings are also emitted (e[1+i]). ``device``:
    where the tables live (None: CUDA)."""
    dev = resolve(device)
    mats = [s for s in sets if isinstance(s, MatrixSet)]
    vecs = [s for s in sets if isinstance(s, VectorSet)]
    n = 1 << nvars
    ncols = mats[0].shape[1]
    fq = ring.fq

    # the tables, written set by set into one tensor: per matrix set
    # [m_0, m'_0, m_1, m'_1, ..., eq], per vector set [m, m', eq]
    w = 2 * ncols + 1
    mles = torch.empty((len(mats) * w + len(vecs) * 3, n, ring.nl), dtype=torch.int64, device=dev)
    alphas: List[int] = []
    for i, s in enumerate(mats):
        c = transcript.get_challenges(nvars)
        beta = transcript.get_challenge()
        blk = mles[i * w : (i + 1) * w]
        mj = _ev_project_dev(ring, s, beta, n, dev).transpose(0, 1)  # [ncols, n, nl]
        blk[0 : 2 * ncols : 2] = mj
        blk[1 : 2 * ncols : 2] = mo.mont_mul(fq, mj, mj)
        del mj
        blk[2 * ncols] = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, c, dev))
        alphas.append(transcript.get_challenge())
    for i, s in enumerate(vecs):
        c = transcript.get_challenges(nvars)
        beta = transcript.get_challenge()
        blk = mles[len(mats) * w + 3 * i : len(mats) * w + 3 * (i + 1)]
        blk[0] = _ev_project_dev(ring, s, beta, n, dev)  # [n, nl]
        blk[1] = mo.mont_mul(fq, blk[0], blk[0])
        blk[2] = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, c, dev))
        alphas.append(transcript.get_challenge())

    # Deviation from setchk.rs:153 (rc only when >1 MATRIX sets): the
    # reference's comb early-returns the first matrix term when rc is absent
    # (setchk.rs:166-183), silently dropping vector sets, while its verifier
    # still adds their claims -- inconsistent for 1-matrix+vector inputs
    # (never exercised there: rgchk always has k*L >= 2 matrices). We batch
    # whenever there is more than one set of any kind, as the JAX package does.
    batched = len(mats) + len(vecs) > 1
    rc = transcript.get_challenge() if batched else None

    nsets = len(mats) + len(vecs)
    q = ring.q
    alpha_pows = np.ones((nsets, ncols), dtype=object)
    for i, a in enumerate(alphas):
        for j in range(1, ncols):
            alpha_pows[i, j] = alpha_pows[i, j - 1] * a % q
        if i >= len(mats):  # vector sets use alpha itself (power 1)
            alpha_pows[i, 0] = a
    rc_pows = np.ones((nsets,), dtype=object)
    if rc is not None:
        for i in range(1, nsets):
            rc_pows[i] = rc_pows[i - 1] * rc % q
    consts = (
        mo.to_mont(fq, mleops.canonical_tensor(ring, alpha_pows, dev)),
        mo.to_mont(fq, mleops.canonical_tensor(ring, rc_pows, dev)),
    )

    comb = _setchk_comb(ring, len(mats), ncols, len(vecs), batched)
    proof, r, _ = psc.prove(ring, transcript, mles, nvars, 3, comb, consts)
    del mles

    # Step 3: MLE openings of the ring-valued columns at r (e) and vectors (b)
    eq_r = mleops.build_eq_scalar(ring, mleops.scalars_dev(ring, r, dev))
    e: List[List[List[list]]] = [_open_columns(ring, mats, eq_r, None)]
    for Mi in M:
        e.append(_open_columns(ring, mats, eq_r, Mi))
    b = [_open_vector(ring, v, eq_r) for v in vecs]

    _absorb_evaluations(transcript, e, b)

    return SetCheckOut(nvars=nvars, r=r, sumcheck_proof=proof, e=e, b=b)


def _bucket_dev(ring: Ring, idx, w_dev) -> np.ndarray:
    """Bucket sums on the weights' device: out[..., m] = sum over x with
    idx[x, ...] = m of w[x], every m at once.

    idx: [n0] or [n0, ncols] (-1 skipped); w_dev: [>=n0, nl] Montgomery.
    Returns an object-int array [(ncols,) d] of canonical F_q values.
    """
    idx = torch.as_tensor(idx, device=w_dev.device).long()
    n0 = idx.shape[0]
    w = w_dev[:n0].reshape((n0,) + (1,) * idx.ndim + (ring.nl,))  # [n0, (1,) 1, nl]
    exps = torch.arange(ring.d, device=w.device)
    step = max(1, _BUCKET_VALUES // (idx[0].numel() * ring.d))
    stacked = None
    for lo in range(0, n0, step):
        hit = (idx[lo : lo + step, ..., None] == exps)[..., None]  # [rows, (ncols,) d, 1]
        wc = w[lo : lo + step]
        part = mo.sum_mod(ring.fq, torch.where(hit, wc, torch.zeros_like(wc)), 0)  # [(ncols,) d, nl]
        stacked = part if stacked is None else mo.add(ring.fq, stacked, part)
    return ring.fq.decode(mo.from_mont(ring.fq, stacked).cpu().numpy())


def _weights_host(ring: Ring, eq_r, n0: int) -> list:
    return mleops.host_ints(ring, eq_r[:n0])


def _bucket_coeffs_host(ring: Ring, coeffs: np.ndarray, w: List[int]) -> np.ndarray:
    """Host fallback for coefficient-form (dishonest-test) sets."""
    q = ring.q
    out = np.zeros(coeffs.shape[1:-1] + (ring.d,), dtype=object)
    for x in range(coeffs.shape[0]):
        if w[x]:
            out = (out + coeffs[x] * w[x]) % q
    return out


def _open_columns(ring: Ring, mats, eq_r, Mi: Optional[SparseMatrix]):
    """e_i[set][col] = MLE eval at r of (M_i *) the ring-valued column
    (setchk.rs:199-242), via the transpose trick: eval = sum_y (M_i^T w)[y] *
    entry[y] with base-field weights w = tensor(r)."""
    if Mi is None:
        w_dev = eq_r
        w_host = None
    else:
        w_full = _weights_host(ring, eq_r, Mi.nrows)
        w_host = Mi.transpose_mul_scalar_host(ring, w_full)
        w_host += [0] * (eq_r.shape[0] - len(w_host))  # M_i narrower than n (m k < n): zero weights
        w_dev = mleops.scalars_dev(ring, w_host, eq_r.device)
    out = []
    for s in mats:
        n0, nc = s.shape
        if s.idx is not None:
            buckets = _bucket_dev(ring, s.idx, w_dev)
        else:
            w = w_host if w_host is not None else _weights_host(ring, eq_r, n0)
            buckets = _bucket_coeffs_host(ring, s.coeffs, w)
        out.append([[int(v) for v in buckets[j]] for j in range(nc)])
    return out


def _open_vector(ring: Ring, v: VectorSet, eq_r) -> list:
    if v.idx is not None:
        return [int(x) for x in _bucket_dev(ring, v.idx, eq_r)]
    w = _weights_host(ring, eq_r, v.coeffs.shape[0])
    return [int(x) for x in _bucket_coeffs_host(ring, v.coeffs, w)]


def _absorb_evaluations(transcript: PlusTranscript, e, b):
    """setchk.rs:344-355."""
    for ek in e:
        for eset in ek:
            for ej in eset:
                transcript.absorb_coeffs(ej)
    for bv in b:
        transcript.absorb_coeffs(bv)


def verify(ring: Ring, out: SetCheckOut, transcript: PlusTranscript) -> List[int]:
    """Verifier (setchk.rs:266-341). Returns the sumcheck point r."""
    n_mat = len(out.e[0])
    n_vec = len(out.b)
    nclaims = n_mat + n_vec
    q = ring.q

    cba = []
    for _ in range(nclaims):
        c = transcript.get_challenges(out.nvars)
        beta = transcript.get_challenge()
        alpha = transcript.get_challenge()
        cba.append((c, beta, alpha))

    rc = transcript.get_challenge() if n_mat + n_vec > 1 else None

    r, expected = psc.verify(ring, transcript, out.nvars, 3, cr.czero(ring), out.sumcheck_proof)

    _absorb_evaluations(transcript, out.e, out.b)

    ver = cr.czero(ring)
    for i, eset in enumerate(out.e[0]):
        c, beta, alpha = cba[i]
        eq = psc.eq_eval_scalar(ring, c, r)
        esum = cr.czero(ring)
        apow = 1
        for ej in eset:
            ev1 = cr.ev(ring, ej, beta)
            ev2 = cr.ev(ring, ej, beta * beta % q)
            term = (ev1 * ev1 - ev2) % q
            esum = cr.cadd(ring, esum, cr.cconst(ring, term * apow % q))
            apow = apow * alpha % q
        rcp = pow(rc, i, q) if rc is not None else 1
        ver = cr.cadd(ring, ver, cr.cscale(ring, eq * rcp % q, esum))
    for i, bv in enumerate(out.b):
        c, beta, alpha = cba[n_mat + i]
        eq = psc.eq_eval_scalar(ring, c, r)
        ev1 = cr.ev(ring, bv, beta)
        ev2 = cr.ev(ring, bv, beta * beta % q)
        claim = (ev1 * ev1 - ev2) % q
        rcp = pow(rc, n_mat + i, q) if rc is not None else 1
        ver = cr.cadd(ring, ver, cr.cconst(ring, eq * alpha % q * claim % q * rcp % q))

    if ver != list(expected):
        raise SetCheckError("recomputed claim mismatch")
    return r
