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
This is the JAX package's ``prove_host``, the only prover path here, and
its ``CombFn`` is a plain callable ``comb(vals, consts)``: stacked MLE
values [nm, M, ncomp, e, nl] plus runtime constants (challenge-derived
tensors) -> combined polynomial values [M, ncomp, e, nl].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch

from .poly import mle as mlemod
from .rings import ops as rops
from .rings.construct import Ring
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
    challenges = []
    round_evals = []
    cur = mles
    for _ in range(nvars):
        evs_host = list(rops.to_host(ring, _round_evs(ring, comb, degree, cur, comb_consts)))
        transcript.absorb_slice(evs_host)
        round_evals.append(evs_host)
        c = transcript.get_challenge()
        transcript.absorb_field_element(c)
        challenges.append(c)
        cur = mlemod.fold(ring, cur, rops.k_to_device(ring, c, cur.device))
    return SumcheckProof(round_evals), challenges, cur.squeeze(1)


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
