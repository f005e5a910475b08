"""Sumcheck over the coefficient-form ring with base-field challenges.

LatticeFold+ runs ``MLSumcheck`` over ``RqPoly``, whose ``BaseRing`` is the
prime field itself: challenges are single F_q scalars and the
squeeze-reabsorb semantics follow latticefold's PoseidonTranscript
(latticefold/src/transcript/poseidon.rs:50-60 with extension_degree == 1).
Two MLE table flavours share the prover:

  - scalar MLEs ("constant" ring elements): [nm, N, nl] limb tensors -- the
    monomial set check's ev-projected tables (setchk.rs:104-116) never leave
    the base field, so that sumcheck runs d times cheaper than a ring one;
  - ring MLEs (NTT form): [nm, N, ncomp, e, nl] -- the commitment
    transformation's batched sumchecks (cm.rs:201-342) and the committed
    R1CS linearization.

Round messages are ring elements; a scalar value v is absorbed as the
constant polynomial [v, 0, ..., 0] (coefficient-form absorb). Folding by a
scalar challenge is a plain Montgomery scale.

Two provers give the same proof. ``prove_host`` computes each round
message over the whole hypercube on the tables' device, brings it to the
host, absorbs it, and folds the tables with the challenge. ``prove_device``
keeps the transcript on the tables' device (``transcript.device``): each
round message is ICRT'd (ring mode) and absorbed there, and the challenge
is squeezed there, so no round reads the device. ``prove`` takes the device
prover for tables on the card and the host prover for tables on the CPU,
as the JAX package takes its device prover on every accelerator. The
hypercube is taken in chunks of pairs so that the comb's and the fold's
temporaries stay bounded; modular sums are exact, so chunking changes no
round message. The first fold writes a new half-size tensor (the caller's
tables stay intact: ``cm`` opens and re-proves its stack), every later
fold writes into the first half of the previous one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch

from .. import modops as mo
from ..rings import ops as rops
from ..transcript import device as dtr
from ..rings.construct import Ring
from . import coeffring as cr
from . import mleops
from .transcript import PlusTranscript

# F_q values per comb input chunk (nm tables x pairs x values per entry)
_CHUNK_VALUES = 1 << 23


@dataclass(frozen=True)
class CombFn:
    """The combining polynomial of a sumcheck: ``fn(vals, consts)`` maps the
    stacked MLE values [nm, M, ...value dims...] to [M, ...]. ``scalar``
    says which table flavour it takes (value dims (nl,) or (ncomp, e, nl))."""

    fn: Callable
    scalar: bool

    def __call__(self, vals, consts):
        return self.fn(vals, consts)


@dataclass
class SumcheckProof:
    # nvars rounds x (degree+1) coefficient-form ring elements (lists of ints)
    round_evals: List[List[list]]


class SumcheckError(Exception):
    pass


def _pair_step(ring: Ring, cur) -> int:
    """Pairs per chunk of ``cur`` [nm, S, ...]: at most _CHUNK_VALUES F_q
    values of input."""
    per_pair = cur.shape[0] * cur[0, 0].numel() // ring.nl
    return max(1, min(cur.shape[1] // 2, _CHUNK_VALUES // max(1, per_pair)))


def _fold(ring: Ring, mles, c, out=None):
    """Fix variable 0 to the F_q scalar ``c`` [nl]: a0 + c (a1 - a0), a
    chunk of pairs at a time into ``out`` [nm, S/2, ...] (None: a new
    tensor). ``out`` may be ``mles[:, :S/2]`` itself: pair j is read from
    rows 2j, 2j + 1 and written to row j, and the chunks go in order, so no
    row is written before it is read."""
    fq = ring.fq
    pairs = mles.shape[1] // 2
    if out is None:
        out = mles.new_empty((mles.shape[0], pairs) + tuple(mles.shape[2:]))
    step = _pair_step(ring, mles)
    for lo in range(0, pairs, step):
        hi = min(pairs, lo + step)
        a0, a1 = mles[:, 2 * lo : 2 * hi : 2], mles[:, 2 * lo + 1 : 2 * hi : 2]
        out[:, lo:hi] = mo.add(fq, a0, mo.mont_mul(fq, mo.sub(fq, a1, a0), c))
    return out


def _fold_round(ring: Ring, cur, mles, c):
    """The tables after a round: the caller's ``mles`` are folded into a new
    tensor (they stay as they were), every later table in place."""
    return _fold(ring, cur, c, None if cur is mles else cur[:, : cur.shape[1] // 2])


def _round_evs(ring: Ring, comb: CombFn, degree: int, cur, consts):
    """One round's message [degree+1, ...value dims...] from tables ``cur``
    [nm, S, ...]: P(x) = sum over pairs of comb((1-x) a0 + x a1)."""
    m = ring.fq
    pairs = cur.shape[1] // 2
    step = _pair_step(ring, cur)
    total = None
    for lo in range(0, pairs, step):
        hi = min(pairs, lo + step)
        a0 = cur[:, 2 * lo : 2 * hi : 2]
        a1 = cur[:, 2 * lo + 1 : 2 * hi : 2]
        evs = [mo.sum_mod(m, comb(a0, consts), 0), mo.sum_mod(m, comb(a1, consts), 0)]
        if degree >= 2:
            diff = mo.sub(m, a1, a0)
            c = a1
            for _ in range(2, degree + 1):
                c = mo.add(m, c, diff)
                evs.append(mo.sum_mod(m, comb(c, consts), 0))
        total = evs if total is None else [mo.add(m, t, v) for t, v in zip(total, evs)]
    return torch.stack(total)


def _message_coeffs(ring: Ring, scalar: bool, evs) -> List[list]:
    """A round message's values as coefficient lists: a scalar v is the
    constant polynomial; a ring value is ICRT'd on the host."""
    if scalar:
        return [cr.cconst(ring, v) for v in mleops.host_ints(ring, evs)]
    return [ring.icrt_host(h) for h in rops.to_host(ring, evs)]


def prove_host(
    ring: Ring,
    transcript: PlusTranscript,
    mles,
    nvars: int,
    degree: int,
    comb: CombFn,
    comb_consts=(),
):
    """Scalar-challenge sumcheck prover (host transcript, one round at a
    time). ``mles``: [nm, 2^nvars, ...]; scalar mode has value dims (nl,),
    ring mode (ncomp, e, nl). Returns (proof, challenges (ints),
    final values [nm, ...] on the tables' device)."""
    if mles.shape[1] != 1 << nvars:
        raise ValueError(f"tables of {mles.shape[1]} rows for {nvars} variables")
    transcript.absorb_coeffs(cr.cconst(ring, nvars))
    transcript.absorb_coeffs(cr.cconst(ring, degree))
    challenges: List[int] = []
    round_evals = []
    cur = mles
    for _ in range(nvars):
        evs_host = _message_coeffs(ring, comb.scalar, _round_evs(ring, comb, degree, cur, comb_consts))
        for e in evs_host:
            transcript.absorb_coeffs(e)
        round_evals.append(evs_host)
        c = transcript.get_challenge()
        challenges.append(c)
        cur = _fold_round(ring, cur, mles, mleops.scalar_dev(ring, c, cur.device))
    return SumcheckProof(round_evals), challenges, cur[:, 0]


def _absorb_rows(ring: Ring, scalar: bool, evs):
    """Device round message -> coefficient-form absorb rows [degree+1, d, nl]
    (Montgomery): a scalar value v is the constant polynomial [v, 0, ...],
    a ring value is ICRT'd on the device (the order of Ring.icrt_host)."""
    if scalar:
        rows = evs.new_zeros((evs.shape[0], ring.d, ring.nl))
        rows[:, 0] = evs
        return rows
    return rops.icrt(ring, evs)


def _device_rounds(ring: Ring, sp, mles, nvars: int, degree: int, comb: CombFn, consts):
    """The rounds of ``prove_device`` on the device sponge ``sp``: each
    round message's absorb rows, the challenge (one F_q element) squeezed
    and re-absorbed, the tables folded. Returns (rows [nvars, degree+1, d,
    nl], chals [nvars, nl], finals [nm, ...]), all on the tables' device."""
    cur = mles
    rows_list, chal_list = [], []
    for _ in range(nvars):
        rows = _absorb_rows(ring, comb.scalar, _round_evs(ring, comb, degree, cur, consts))
        sp.absorb(rows.reshape(-1, ring.nl))
        c = sp.squeeze(1)
        sp.absorb(c)
        rows_list.append(rows)
        chal_list.append(c[0])
        cur = _fold_round(ring, cur, mles, c[0])
    return torch.stack(rows_list), torch.stack(chal_list), cur[:, 0]


def prove_device(
    ring: Ring,
    transcript: PlusTranscript,
    mles,
    nvars: int,
    degree: int,
    comb: CombFn,
    comb_consts=(),
):
    """``prove_host`` with the transcript on the tables' device: the same
    (proof, challenges (ints), final values [nm, ...] on the tables' device)
    and the same host transcript state afterwards."""
    if mles.shape[1] != 1 << nvars:
        raise ValueError(f"tables of {mles.shape[1]} rows for {nvars} variables")
    fq = ring.fq
    transcript.absorb_coeffs(cr.cconst(ring, nvars))
    transcript.absorb_coeffs(cr.cconst(ring, degree))
    state0, idx0, abs0 = dtr.export_state(ring, transcript, mles.device)
    sp = dtr.TraceSponge(ring, state0, idx0, abs0)
    all_rows, chals, finals = _device_rounds(ring, sp, mles, nvars, degree, comb, comb_consts)
    dtr.import_state(ring, transcript, sp.state, sp.index, sp.absorbing)
    rows_host = fq.decode(mo.from_mont(fq, all_rows).cpu().numpy())  # [nvars, deg+1, d]
    round_evals = [[[int(v) for v in rows_host[r, i]] for i in range(degree + 1)] for r in range(nvars)]
    challenges = mleops.host_ints(ring, chals)
    return SumcheckProof(round_evals), challenges, finals


def prove(
    ring: Ring,
    transcript: PlusTranscript,
    mles,
    nvars: int,
    degree: int,
    comb: CombFn,
    comb_consts=(),
):
    """The scalar-challenge sumcheck prover: ``prove_device`` for tables on
    the card, ``prove_host`` for tables on the CPU; the same proof bytes."""
    fn = prove_host if mles.device.type == "cpu" else prove_device
    return fn(ring, transcript, mles, nvars, degree, comb, comb_consts)


def _coeff_eval_lagrange(ring: Ring, evals: Sequence[list], r: int) -> list:
    """Interpolate coefficient-form ring values at integer nodes 0..deg, then
    evaluate at the F_q scalar r (verifier.rs:139-257 semantics)."""
    q = ring.q
    n = len(evals)
    for i in range(n):
        if r == i % q:
            return list(evals[i])
    result = cr.czero(ring)
    for i in range(n):
        num, den = 1, 1
        for j in range(n):
            if j == i:
                continue
            num = num * ((r - j) % q) % q
            den = den * ((i - j) % q) % q
        lag = num * pow(den, q - 2, q) % q
        result = cr.cadd(ring, result, cr.cscale(ring, lag, evals[i]))
    return result


def verify(
    ring: Ring,
    transcript: PlusTranscript,
    nvars: int,
    degree: int,
    claimed_sum: list,
    proof: SumcheckProof,
):
    """Returns (point (list of F_q ints), expected evaluation (coeff list))."""
    transcript.absorb_coeffs(cr.cconst(ring, nvars))
    transcript.absorb_coeffs(cr.cconst(ring, degree))
    if len(proof.round_evals) != nvars:
        raise SumcheckError(f"{len(proof.round_evals)} rounds for {nvars} variables")
    challenges = []
    for rnd in range(nvars):
        evals = proof.round_evals[rnd]
        if len(evals) != degree + 1:
            raise SumcheckError("wrong number of evaluations")
        for e in evals:
            transcript.absorb_coeffs(e)
        challenges.append(transcript.get_challenge())
    expected = claimed_sum
    for rnd in range(nvars):
        evals = proof.round_evals[rnd]
        if cr.cadd(ring, evals[0], evals[1]) != list(expected):
            raise SumcheckError(f"sumcheck round {rnd}: p0+p1 != expected")
        expected = _coeff_eval_lagrange(ring, evals, challenges[rnd])
    return challenges, expected


def eq_eval_scalar(ring: Ring, xs: Sequence[int], ys: Sequence[int]) -> int:
    q = ring.q
    res = 1
    for x, y in zip(xs, ys):
        res = res * ((2 * x * y - x - y + 1) % q) % q
    return res
