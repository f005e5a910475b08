"""Ring-adapted multilinear sumcheck (tensor prover, host verifier).

Protocol-identical to the reference ``MLSumcheck``: absorb nvars and degree;
each round the prover sends P(0..degree) evaluations (absorbed), the verifier
squeezes a K challenge (absorbed back); the verifier defers all checks to the
end (p0 + p1 == expected; next expected by Lagrange interpolation).

The prover is the per-round host-transcript prover: each round message is
computed over the whole hypercube at once on the tables' device, brought to
the host, absorbed, and the challenge folds the tables. The hypercube is
processed in chunks of pairs so that the comb's temporaries stay bounded;
modular sums are exact, so chunking leaves every round message unchanged.
This is the JAX package's ``prove_host``, and its ``CombFn`` is a plain
callable ``comb(vals, consts)``: stacked MLE values [nm, M, ncomp, e, nl]
plus runtime constants (challenge-derived tensors) -> combined polynomial
values [M, ncomp, e, nl]. ``prove_host_bigm`` is the same prover with the
folding sumcheck's f-hat rows kept subfield-compact through the first
rounds (the big-m path; see the note above it).

``trace_prove`` is the same prover with the transcript on the tables'
device (``transcript.device``), over an existing device sponge: the round
messages are absorbed and the challenges squeezed there, so no round reads
the device. The single-dispatch fold (``nifs.device_step``) runs it twice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import modops as mo
from .poly import mle as mlemod
from .rings import ops as rops
from .rings.construct import Ring
from .device import constant
from .transcript import Transcript

# ring elements per comb input chunk (nm tables x pairs)
_CHUNK_ELEMS = 1 << 19


@dataclass
class SumcheckProof:
    round_evals: List[List[tuple]]  # nvars rounds x (degree+1) host ring elements


def _round_evs(ring: Ring, comb: Callable, degree: int, cur, consts):
    """One round's prover message [degree+1, ncomp, e, nl] from tables ``cur``
    [nm, S, ...]: P(x) = sum over pairs of comb((1-x) a0 + x a1)."""
    nm, S = cur.shape[0], cur.shape[1]
    pairs = S // 2
    step = max(1, min(pairs, _CHUNK_ELEMS // max(1, nm)))
    total = None
    for lo in range(0, pairs, step):
        hi = min(pairs, lo + step)
        a0 = cur[:, 2 * lo : 2 * hi : 2]
        a1 = cur[:, 2 * lo + 1 : 2 * hi : 2]
        evs = [
            rops.ring_sum(ring, comb(a0, consts), 0),
            rops.ring_sum(ring, comb(a1, consts), 0),
        ]
        if degree >= 2:
            diff = rops.ring_sub(ring, a1, a0)
            c = a1
            for _ in range(2, degree + 1):
                c = rops.ring_add(ring, c, diff)
                evs.append(rops.ring_sum(ring, comb(c, consts), 0))
        total = evs if total is None else [rops.ring_add(ring, t, v) for t, v in zip(total, evs)]
    return torch.stack(total)


def _rounds(ring: Ring, transcript: Transcript, cur, nrounds: int, degree: int,
            comb: Callable, consts, challenges: list, round_evals: list):
    """``nrounds`` rounds on the tables ``cur`` [nm, 2^nrounds, ...]: each
    round's message is absorbed and its challenge folds the tables.
    Appends to ``challenges`` / ``round_evals``; returns the folded tables
    [nm, ncomp, e, nl]."""
    for _ in range(nrounds):
        evs_host = list(rops.to_host(ring, _round_evs(ring, comb, degree, cur, consts)))
        transcript.absorb_slice(evs_host)
        round_evals.append(evs_host)
        c = transcript.get_challenge()
        transcript.absorb_field_element(c)
        challenges.append(c)
        cur = mlemod.fold(ring, cur, rops.k_to_device(ring, c, cur.device))
    return cur.squeeze(1)


def prove(
    ring: Ring,
    transcript: Transcript,
    mles,
    nvars: int,
    degree: int,
    comb: Callable,
    comb_consts=(),
):
    """Host-transcript prover. ``mles``: [nm, 2^nvars, ncomp, e, nl].
    Returns (SumcheckProof, challenges (K elts), final_vals [nm, ncomp, e, nl])
    where final_vals[i] = mle_i(r) -- the fully folded tables."""
    assert mles.shape[1] == 1 << nvars
    transcript.absorb(ring.embed_int(nvars))
    transcript.absorb(ring.embed_int(degree))
    challenges, round_evals = [], []
    final_vals = _rounds(ring, transcript, mles, nvars, degree, comb, comb_consts, challenges, round_evals)
    return SumcheckProof(round_evals), challenges, final_vals


# ---------------------------------------------------------------------------
# device-transcript prover
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _embed_int_np(ring: Ring, v: int):
    R = 1 << (32 * ring.nl)
    vals = np.zeros((ring.ncomp, ring.e), dtype=object)
    vals[:, 0] = v % ring.q * R % ring.q
    return ring.fq.encode(vals)


@functools.lru_cache(maxsize=None)
def _embed_int_dev(ring: Ring, v: int, device: torch.device):
    """Diagonal ring embedding of a small int as a device constant [c, e, nl]."""
    return constant(_embed_int_np(ring, v), device)


def trace_prove(sp, mles, nvars: int, degree: int, comb: Callable, consts=()):
    """Sumcheck prover over an existing device sponge ``sp``
    (``transcript.device.TraceSponge``): absorbs nvars and degree, runs all
    rounds at their natural, shrinking shapes, and leaves ``sp`` at the
    post-sumcheck duplex state; the absorb / squeeze schedule of
    ``prove``. Returns (evals [nvars, degree+1, ncomp, e, nl], chals
    [nvars, e, nl], finals [nm, ncomp, e, nl]), all on the tables' device."""
    ring = sp.ring
    dev = mles.device
    sp.absorb_ring(_embed_int_dev(ring, nvars, dev))
    sp.absorb_ring(_embed_int_dev(ring, degree, dev))
    cur = mles
    evs_list, chal_list = [], []
    for _ in range(nvars):
        evs = _round_evs(ring, comb, degree, cur, consts)
        sp.absorb_ring(evs)
        c = sp.get_challenge()
        sp.absorb_field_element(c)
        evs_list.append(evs)
        chal_list.append(c)
        cur = mlemod.fold(ring, cur, c)
    return torch.stack(evs_list), torch.stack(chal_list), cur.squeeze(1)


# ---------------------------------------------------------------------------
# big-m prover: compact f-hat rows through the first rounds
# ---------------------------------------------------------------------------
#
# The folding sumcheck's 2K*tau f-hat rows start subfield-compact
# ([m, ncomp, nl]: K-coordinate 0 only) and become K-valued only when folded
# with the round challenges; expanded, they are e times larger (9 GB of
# int64 lanes for Goldilocks at m = 2^18). This prover keeps the compact
# rows through the first J = nvars - expand_nvars rounds with the fold
# weights
#
#   W_j[y] = prod_{i<j} ((1 - c_i) if bit_i(y) == 0 else c_i),  y in [2^j],
#
# so that round j's folded value is fold_j[x] = sum_y W_j[y] orig[x 2^j + y]
# (exact mod q), made a chunk at a time inside the round message. After J
# rounds the rows are 2^J times shorter and are expanded in full; the
# remaining rounds run as ``prove`` runs them. The round messages, and so
# the proof, are the standard prover's.

# ring elements of folded f-hat rows per chunk of a W-tensor round
# (rows x chunk positions): 2^22 elements are 1.6 GB of int64 lanes at
# Goldilocks (e 3, nl 2), so a chunk's fold and comb transients take a few
# GB of an H100's 80 GB while the first round at m = 2^18 (90 rows) runs
# in 6 chunks. The whole big-m Goldilocks prove at m = 2^18 peaked at 19.6 GB
# (chip_smoke.peak_sweep; NVIDIA H100 80GB HBM3, 700 W). The TPU's 2^11
# pairs were sized for a 16 GB chip.
_BIGM_CHUNK_ELEMS = 1 << 22


def _w_tensor(ring: Ring, chals, device) -> torch.Tensor:
    """Challenges c_0..c_{j-1} -> the weights [2^j, e, nl] (Montgomery):
    W[y] = prod_i w_i(bit_i(y)), w_i(0) = 1 - c_i, w_i(1) = c_i; W[()] = 1."""
    K = ring.K
    ws = [K.one()]
    for c in chals:
        wc0 = K.sub(K.one(), c)
        ws = [K.mul(w, wc0) for w in ws] + [K.mul(w, c) for w in ws]
    return torch.stack([rops.k_to_device(ring, w, device) for w in ws])


def _fold_compact(ring: Ring, sub, W):
    """sum_y W[y] * sub[:, :, y]: compact rows ``sub`` [nf, S, 2^j, ncomp, nl]
    -> K-valued [nf, S, ncomp, e, nl], one term live at a time."""
    acc = None
    for y in range(sub.shape[2]):
        term = mo.mont_mul(ring.fq, sub[:, :, y, :, None, :], W[y])
        acc = term if acc is None else mo.add(ring.fq, acc, term)
        del term
    return acc


def _bigm_round_evs(ring: Ring, comb: Callable, degree: int, cur5, fhat5, j: int, W, consts,
                    chunk_pairs: Optional[int] = None):
    """Round ``j``'s message [degree+1, ncomp, e, nl] from the expanded
    tables ``cur5`` [n5, S, ...] (already folded j times) and the compact
    f-hat rows ``fhat5`` [2K, tau, S 2^j, ncomp, nl], folded on the fly a
    chunk of ``chunk_pairs`` pairs at a time (default: _BIGM_CHUNK_ELEMS
    elements of folded rows). A pair x reads the contiguous original range
    [x 2^(j+1), (x+1) 2^(j+1)), so every chunk is a ``narrow`` view."""
    S = cur5.shape[1]
    nf = fhat5.shape[0] * fhat5.shape[1]
    rows = fhat5.view((nf,) + tuple(fhat5.shape[2:]))  # a view: never copy the table
    if chunk_pairs is None:
        chunk_pairs = max(1, _BIGM_CHUNK_ELEMS // (2 * nf))
    total = None
    for lo in range(0, S // 2, chunk_pairs):
        cp = min(chunk_pairs, S // 2 - lo)
        sub = rows.narrow(1, lo << (j + 1), cp << (j + 1))
        folded = _fold_compact(ring, sub.view(nf, 2 * cp, 1 << j, ring.ncomp, ring.nl), W)
        a = torch.cat([cur5.narrow(1, 2 * lo, 2 * cp), folded])
        del folded
        evs = _round_evs(ring, comb, degree, a, consts)
        del a
        total = evs if total is None else rops.ring_add(ring, total, evs)
    return total


def _bigm_expand(ring: Ring, fhat5, j: int, W):
    """The compact rows folded j times, in full K form:
    out[x] = sum_y W[y] orig[x 2^j + y]; [nf, S, ncomp, e, nl]."""
    nf = fhat5.shape[0] * fhat5.shape[1]
    tot = fhat5.shape[2]
    return _fold_compact(ring, fhat5.view(nf, tot >> j, 1 << j, ring.ncomp, ring.nl), W)


def prove_host_bigm(
    ring: Ring,
    transcript: Transcript,
    full5,
    fhat5,
    nvars: int,
    degree: int,
    comb: Callable,
    comb_consts=(),
    expand_nvars: int = 13,
):
    """``prove`` with the compact f-hat rows kept unexpanded through the
    first ``nvars - expand_nvars`` rounds (see the note above).

    ``full5``: [n5, 2^nvars, ncomp, e, nl] expanded rows (eq / combined);
    ``fhat5``: [2K, tau, 2^nvars, ncomp, nl] compact rows, or a one-element
    list holding them: the list's entry is dropped after the expansion, so
    the table is freed mid-sumcheck once the caller holds no other
    reference. The comb sees [full5..., f-hat rows (2K-major)], the
    standard path's order. Returns (SumcheckProof, challenges, final_vals
    [n5 + nf, ncomp, e, nl])."""
    fhat_box = fhat5 if isinstance(fhat5, list) else [fhat5]
    fhat5 = None
    cur5, full5 = full5, None
    assert cur5.shape[1] == 1 << nvars and fhat_box[0].shape[2] == 1 << nvars
    dev = cur5.device
    transcript.absorb(ring.embed_int(nvars))
    transcript.absorb(ring.embed_int(degree))
    J = max(0, nvars - expand_nvars)
    challenges, round_evals = [], []
    for j in range(J):
        W = _w_tensor(ring, challenges, dev)
        evs = _bigm_round_evs(ring, comb, degree, cur5, fhat_box[0], j, W, comb_consts)
        evs_host = list(rops.to_host(ring, evs))
        transcript.absorb_slice(evs_host)
        round_evals.append(evs_host)
        c = transcript.get_challenge()
        transcript.absorb_field_element(c)
        challenges.append(c)
        cur5 = mlemod.fold(ring, cur5, rops.k_to_device(ring, c, dev))

    fh_full = _bigm_expand(ring, fhat_box[0], J, _w_tensor(ring, challenges, dev))
    fhat_box[0] = None  # the compact rows are dead: free the table
    cur = torch.cat([cur5, fh_full])
    del cur5, fh_full
    final_vals = _rounds(ring, transcript, cur, nvars - J, degree, comb, comb_consts, challenges, round_evals)
    return SumcheckProof(round_evals), challenges, final_vals


# ---------------------------------------------------------------------------
# host verifier (copied from the JAX package: host code)
# ---------------------------------------------------------------------------


def interpolate_uni_poly(ring: Ring, evals: Sequence[tuple], r) -> tuple:
    """Lagrange-interpolate P through (i, evals[i]) and evaluate at K point r."""
    K = ring.K
    n = len(evals)
    # if r is one of the sample points, return directly
    for i in range(n):
        if r == K.embed(i):
            return evals[i]
    result = ring.zero()
    for i in range(n):
        num = K.one()
        den = K.one()
        for j in range(n):
            if j == i:
                continue
            num = K.mul(num, K.sub(r, K.embed(j)))
            den = K.mul(den, K.sub(K.embed(i), K.embed(j)))
        lag = K.mul(num, K.inv(den))
        result = ring.radd(result, ring.rmul(evals[i], ring.embed_k(lag)))
    return result


class SumcheckError(Exception):
    pass


def verify(
    ring: Ring,
    transcript: Transcript,
    nvars: int,
    degree: int,
    claimed_sum,
    proof: SumcheckProof,
):
    """Returns (point (list of K elts), expected_evaluation (ring elt))."""
    transcript.absorb(ring.embed_int(nvars))
    transcript.absorb(ring.embed_int(degree))
    challenges = []
    for rnd in range(nvars):
        evals = proof.round_evals[rnd]
        if len(evals) != degree + 1:
            raise SumcheckError("wrong number of evaluations")
        transcript.absorb_slice(evals)
        c = transcript.get_challenge()
        transcript.absorb_field_element(c)
        challenges.append(c)
    expected = claimed_sum
    for rnd in range(nvars):
        evals = proof.round_evals[rnd]
        if ring.radd(evals[0], evals[1]) != expected:
            raise SumcheckError(f"sumcheck round {rnd}: p0+p1 != expected")
        expected = interpolate_uni_poly(ring, evals, challenges[rnd])
    return challenges, expected


def eq_eval(ring: Ring, xs: Sequence[tuple], ys: Sequence[tuple]) -> tuple:
    """eq(x, y) for K points, as a ring elt."""
    K = ring.K
    res = K.one()
    for x, y in zip(xs, ys):
        xy = K.mul(x, y)
        term = K.add(K.add(xy, xy), K.sub(K.sub(K.one(), x), y))
        res = K.mul(res, term)
    return ring.embed_k(res)
