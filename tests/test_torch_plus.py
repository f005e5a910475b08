"""The port's LatticeFold+ (``latticefold_torch.plus``) against the JAX
package's (``latticefold_tpu.plus``): the coefficient-form algebra, the
scalar-challenge sumcheck in both table modes, the monomial set check, the
committed-R1CS linearization and the whole prover, on the fixtures of
tests/test_plus.py (Frog). Inputs are made with numpy from a seed, or are
the JAX tests' own fixtures; the port runs on the CPU.

The JAX side runs as tests/test_plus.py runs it: eagerly, under
``jax.disable_jit()`` (its combs are XLA:CPU compile bombs). Its whole
prove at n 2^13 (the smallest n that Frog's l = 22 allows) takes many
minutes that way, so the live comparison of whole proofs is slow-marked;
tier-1 holds the port's n 2^13 proof to the SHA-256 of the JAX prover's
bytes (``JAX_PLUS_E2E_SHA256``, which the slow test re-derives from the
JAX prover). Tolerance: exact equality -- every value is an integer mod q,
and proofs must be the same bytes."""

import copy
import hashlib
import math

import jax
import numpy as np
import pytest
import torch

import latticefold_tpu.serialization as jser
from latticefold_torch import convert
from latticefold_torch import modops as tmo
from latticefold_torch import serialization as tser
from latticefold_torch.arith.sparse import SparseMatrix as TSparseMatrix
from latticefold_torch.commitment import AjtaiScheme as TAjtaiScheme
from latticefold_torch.plus import ComR1CS as TComR1CS
from latticefold_torch.plus import DecompParameters as TDecompParameters
from latticefold_torch.plus import LinParameters as TLinParameters
from latticefold_torch.plus import PlusParameters as TPlusParameters
from latticefold_torch.plus import PlusProver as TPlusProver
from latticefold_torch.plus import PlusTranscript as TPlusTranscript
from latticefold_torch.plus import PlusVerifier as TPlusVerifier
from latticefold_torch.plus import coeffring as tcr
from latticefold_torch.plus import decomp as tdecomp
from latticefold_torch.plus import estimate_bound as port_estimate_bound
from latticefold_torch.plus import linearize as tlinearize
from latticefold_torch.plus import setchk as tsetchk
from latticefold_torch.plus import sumcheck as tpsc
from latticefold_torch.plus import verify_linearization as tverify_linearization
from latticefold_torch.plus.r1cs import r1cs_decomposed_square as tr1cs_decomposed_square
from latticefold_torch.rings import ops as tops
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu import modops as jmo
from latticefold_tpu.commitment import AjtaiScheme
from latticefold_tpu.plus import (
    ComR1CS,
    LinParameters,
    PlusParameters,
    PlusProver,
    PlusTranscript,
    PlusVerifier,
    estimate_bound,
    linearize,
)
from latticefold_tpu.plus import coeffring as jcr
from latticefold_tpu.plus import setchk as jsetchk
from latticefold_tpu.plus import sumcheck as jpsc
from latticefold_tpu.plus.r1cs import r1cs_decomposed_square
from latticefold_tpu.rings import ops as jops
from test_plus import RING, _idx_identity, _plus_setup, dparams, identity_sparse, ring_vec_from_coeff_rows

TRING = tget_ring("frog")
CPU = "cpu"

# SHA-256 of the JAX prover's serialize_plus_proof bytes for _plus_setup(n=2^13, k=1),
# one PlusProver.prove (re-derived by test_plus_e2e_matches_jax_live)
JAX_PLUS_E2E_SHA256 = "a155fe6c1293ac985ca3b7752773dfffe2fcccb7dd9014b8046dfc8ace221bf0"


@pytest.fixture(autouse=True)
def _eager_on_cpu():
    """The JAX side eagerly, as tests/test_plus.py runs it on the CPU."""
    with jax.disable_jit():
        yield


def rand_limbs(ring, shape, rng):
    """Canonical F_q values (valid Montgomery values too) as uint32 limbs [*shape, nl]."""
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (ring.nl,), dtype=np.uint64)
    limbs[..., -1] %= np.uint64(ring.q >> (32 * (ring.nl - 1)))
    return limbs.astype(np.uint32)


# ---------------------------------------------------------------------------
# coefficient-form algebra
# ---------------------------------------------------------------------------


def test_psi_exp_identity():
    dp = TRING.d // 2
    psi = list(tcr.psi_coeffs(TRING))
    assert psi == list(jcr.psi_coeffs(RING))
    for a in range(-dp + 1, dp + 1):
        assert tcr.ct(tcr.cmul(TRING, psi, tcr.exp_coeffs(TRING, a))) == a % TRING.q


def test_monomial_table_matches_jax():
    want = np.asarray(jcr.monomial_table_np(RING))
    assert np.array_equal(tcr.monomial_table_np(TRING), want)
    assert np.array_equal(convert.to_numpy(tcr.monomial_table(TRING, torch.device(CPU))), want)


# ---------------------------------------------------------------------------
# the scalar-challenge sumcheck, both table modes
# ---------------------------------------------------------------------------


def _combs(scalar):
    """(JAX CombFn, port CombFn, degree): scalar mode v0 v1 v2 (degree 3),
    ring mode v0 *_K v1 + v2 (degree 2)."""
    jm, tm = RING.fq, TRING.fq
    if scalar:
        def jfn(v, c):
            return jmo.mont_mul(jm, jmo.mont_mul(jm, v[0], v[1]), v[2])

        def tfn(v, c):
            return tmo.mont_mul(tm, tmo.mont_mul(tm, v[0], v[1]), v[2])
        degree = 3
    else:
        def jfn(v, c):
            return jmo.add(jm, jops.ext_mul(RING, v[0], v[1]), v[2])

        def tfn(v, c):
            return tmo.add(tm, tops.ext_mul(TRING, v[0], v[1]), v[2])
        degree = 2
    key = f"test_torch_plus:{scalar}"
    return jpsc.CombFn(RING, jfn, key=key, scalar=scalar), tpsc.CombFn(tfn, scalar=scalar), degree


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "ring"])
@pytest.mark.parametrize("nvars", [3, 4])
def test_sumcheck_matches_jax(scalar, nvars):
    """prove_host on seeded tables [3, 2^nvars, ...]: equal round
    evaluations, challenges and final values; the port's verify accepts
    (its expected value is the comb at the final values) and raises
    SumcheckError on a changed evaluation."""
    jcomb, tcomb, degree = _combs(scalar)
    vdims = () if scalar else (RING.ncomp, RING.e)
    tabs = rand_limbs(RING, (3, 1 << nvars) + vdims, np.random.default_rng(100 * nvars + scalar))
    jproof, jch, jfinal = jpsc.prove_host(RING, PlusTranscript(RING), jax.numpy.asarray(tabs), nvars, degree, jcomb)
    mles = convert.tensor(tabs, CPU)
    proof, ch, final = tpsc.prove_host(TRING, TPlusTranscript(TRING), mles, nvars, degree, tcomb)
    assert proof.round_evals == jproof.round_evals
    assert ch == jch
    assert np.array_equal(convert.to_numpy(final), np.asarray(jfinal))

    claimed = tpsc._message_coeffs(TRING, scalar, tmo.sum_mod(TRING.fq, tcomb(mles, ()), 0)[None])[0]
    point, expected = tpsc.verify(TRING, TPlusTranscript(TRING), nvars, degree, claimed, proof)
    assert point == ch
    assert expected == tpsc._message_coeffs(TRING, scalar, tcomb(final[:, None], ()))[0]
    bad = copy.deepcopy(proof)
    bad.round_evals[1][0][0] = (bad.round_evals[1][0][0] + 1) % TRING.q
    with pytest.raises(tpsc.SumcheckError):
        tpsc.verify(TRING, TPlusTranscript(TRING), nvars, degree, claimed, bad)


# ---------------------------------------------------------------------------
# the monomial set check (tests/test_plus.py:112-176)
# ---------------------------------------------------------------------------


def _bad_coeffs(n):
    coeffs = np.zeros((n, n, RING.d), dtype=object)
    for i in range(n):
        coeffs[i, i, 0] = 1
    coeffs[0, 0, 1] = 1  # 1 + X: not a monomial
    return coeffs


SET_CASES = {
    "single": lambda mod, n: [mod.MatrixSet(idx=_idx_identity(n, RING.d))],
    "batched_and_vectors": lambda mod, n: [
        mod.MatrixSet(idx=_idx_identity(n, RING.d)),
        mod.MatrixSet(idx=_idx_identity(n, RING.d)),
        mod.VectorSet(idx=np.zeros(n, dtype=np.int32)),
        mod.VectorSet(idx=np.full(n, 2, dtype=np.int32)),
    ],
    "bad": lambda mod, n: [mod.MatrixSet(idx=_idx_identity(n, RING.d)), mod.MatrixSet(coeffs=_bad_coeffs(n))],
}


@pytest.mark.parametrize("case", list(SET_CASES))
def test_set_check_matches_jax(case):
    """The proof equals the JAX proof field by field; the port's verifier
    accepts the honest sets and raises SetCheckError on the dishonest one."""
    n = 4
    jout = jsetchk.set_check(RING, 2, SET_CASES[case](jsetchk, n), [], PlusTranscript(RING))
    out = tsetchk.set_check(TRING, 2, SET_CASES[case](tsetchk, n), [], TPlusTranscript(TRING), CPU)
    assert out.nvars == jout.nvars
    assert out.r == jout.r
    assert out.sumcheck_proof.round_evals == jout.sumcheck_proof.round_evals
    assert out.e == jout.e
    assert out.b == jout.b
    if case == "bad":
        with pytest.raises(tsetchk.SetCheckError):
            tsetchk.verify(TRING, out, TPlusTranscript(TRING))
    else:
        assert tsetchk.verify(TRING, out, TPlusTranscript(TRING)) == out.r


# ---------------------------------------------------------------------------
# the committed R1CS and the whole prover
# ---------------------------------------------------------------------------


def _tdparams(k):
    b = TRING.d // 2
    return TDecompParameters(b=b, k=k, l=math.ceil(math.log(TRING.q) / math.log(b)))


def _t_identity_sparse(n):
    return TSparseMatrix(TRING, n, n, [[(1, i)] for i in range(n)])


def port_plus_setup(n, k, kappa=1, B=None, seed=7, device=CPU):
    """tests/test_plus.py's _plus_setup in the port (identity R1CS, z all
    ones, Ajtai seed 7): (scheme, ComR1CS, LinParameters, B)."""
    m = n // k
    if B is None:
        B = port_estimate_bound(TRING.d * 128, 3, TRING.d, k) + 1
    A_, B_, C_ = tr1cs_decomposed_square(
        TRING, _t_identity_sparse(m), _t_identity_sparse(m), _t_identity_sparse(m), n, B, k)
    scheme = TAjtaiScheme(TRING, kappa, n, seed=seed, device=device)
    z = tops.to_device(TRING, [TRING.crt_host([1] + [0] * (TRING.d - 1)) for _ in range(m)], device)
    c = TComR1CS.new(TRING, [A_, B_, C_], z, 1, B, k, scheme)
    return scheme, c, TLinParameters(kappa=kappa, decomp=_tdparams(k)), B


def _jax_com_r1cs_parts(c):
    return dict(matrices=[(m.nrows, m.ncols, m.rows) for m in c.x.matrices], z=np.asarray(c.x.z),
                f=np.asarray(c.f), cm_f=c.x.cm_f, l_in=c.x.l_in)


def test_comr1cs_linearize_matches_jax():
    """_plus_setup(n=64, k=2): the port's ComR1CS.new equals the JAX
    instance (matrices, z, f, cm_f); linearize gives the JAX proof and
    LinB; the port's verify_linearization accepts."""
    ring, scheme, c, params, B = _plus_setup(n=64, k=2)
    _, tc, tparams, tB = port_plus_setup(64, 2)
    assert tB == B and tparams.decomp.l == params.decomp.l
    parts = _jax_com_r1cs_parts(c)
    assert [(m.nrows, m.ncols, m.rows) for m in tc.x.matrices] == parts["matrices"]
    assert np.array_equal(convert.to_numpy(tc.x.z), parts["z"])
    assert np.array_equal(convert.to_numpy(tc.f), parts["f"])
    assert tc.x.cm_f == parts["cm_f"]

    jlinb, jp = linearize(c, PlusTranscript(ring))
    linb, p = tlinearize(tc, TPlusTranscript(TRING))
    assert p.sumcheck.round_evals == jp.sumcheck.round_evals
    assert (p.nvars, p.r, p.v, p.va, p.vb, p.vc) == (jp.nvars, jp.r, jp.v, jp.va, jp.vb, jp.vc)
    assert (linb.x.cm_f, linb.x.r, linb.x.v) == (jlinb.x.cm_f, jlinb.x.r, jlinb.x.v)
    assert np.array_equal(convert.to_numpy(linb.f), np.asarray(jlinb.f))
    tverify_linearization(TRING, p, TPlusTranscript(TRING))


RG_N = 1 << 13  # tau length kappa*k*d*d*l: Frog's l = 22 forces n >= 2^13 at k 1


def _port_prove(setup):
    scheme, c, params, B = setup
    pparams = TPlusParameters(lin=params, B=B)
    proof = TPlusProver(scheme=scheme, M=c.x.matrices, transcript=TPlusTranscript(TRING), params=pparams).prove([c])
    return proof, pparams, c.x.matrices


@pytest.fixture(scope="module")
def port_e2e():
    """One PlusProver.prove on _plus_setup(n=2^13, k=1), in the port on the CPU."""
    proof, pparams, M = _port_prove(port_plus_setup(RG_N, 1))
    return proof, pparams, M, tser.serialize_plus_proof(TRING, proof)


def test_plus_e2e_port(port_e2e):
    """The whole slice in tier-1: the port's proof bytes hash to the JAX
    prover's digest; the port's verifier accepts the proof and rejects both
    tampered proofs of tests/test_plus.py:331-344; the port's serialization
    round-trips, and the JAX reader reads the port's bytes back to them."""
    proof, pparams, M, blob = port_e2e
    assert hashlib.sha256(blob).hexdigest() == JAX_PLUS_E2E_SHA256
    assert TPlusVerifier(ring=TRING, M=M, transcript=TPlusTranscript(TRING), params=pparams).verify(proof)

    rt = tser.deserialize_plus_proof(TRING, blob)
    assert tser.serialize_plus_proof(TRING, rt) == blob
    assert jser.serialize_plus_proof(RING, jser.deserialize_plus_proof(RING, blob)) == blob

    bad = copy.deepcopy(proof)
    bad.dproof.C[0][0][0] = (bad.dproof.C[0][0][0] + 1) % TRING.q
    with pytest.raises(tdecomp.DecompError):
        TPlusVerifier(ring=TRING, M=M, transcript=TPlusTranscript(TRING), params=pparams).verify(bad)

    bad2 = copy.deepcopy(proof)
    bad2.cmproof.evals[0][0].groups[0][2][0] = (bad2.cmproof.evals[0][0].groups[0][2][0] + 1) % TRING.q
    with pytest.raises(Exception):
        TPlusVerifier(ring=TRING, M=M, transcript=TPlusTranscript(TRING), params=pparams).verify(bad2)


@pytest.mark.slow
def test_plus_e2e_matches_jax_live(port_e2e):
    """The JAX prover on the same instance (carried across by convert): its
    bytes equal the port's and hash to JAX_PLUS_E2E_SHA256, and the JAX
    verifier accepts the port's proof."""
    ring, scheme, c, params, B = _plus_setup(n=RG_N, k=1)
    pparams = PlusParameters(lin=params, B=B)
    jblob = jser.serialize_plus_proof(
        ring, PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams).prove([c]))
    assert hashlib.sha256(jblob).hexdigest() == JAX_PLUS_E2E_SHA256

    tscheme = convert.ajtai_scheme(TRING, np.asarray(scheme.matrix), CPU)
    tc = convert.com_r1cs(TRING, device=CPU, **_jax_com_r1cs_parts(c))
    proof, _, _ = _port_prove((tscheme, tc, TLinParameters(kappa=params.kappa, decomp=_tdparams(1)), B))
    blob = tser.serialize_plus_proof(TRING, proof)
    assert blob == jblob == port_e2e[3]
    assert PlusVerifier(ring=ring, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams).verify(
        jser.deserialize_plus_proof(ring, blob))


@pytest.mark.slow
def test_plus_multi_round_matches_jax():
    """Two accumulation rounds at tests/test_plus.py's test_plus_multi_round
    shape (n 2^15, k 4, kappa 1, B = estimate_bound // 2): each round's
    bytes equal the JAX prover's; the second round folds an accumulator of
    L = 3, and the port's verifier, carrying its transcript, accepts both."""
    ring, n, k = RING, 1 << 15, 4
    m = n // k
    B = estimate_bound(ring.d * 128, 3, ring.d, k) // 2
    A_, B_, C_ = r1cs_decomposed_square(ring, *(identity_sparse(m) for _ in range(3)), n, B, k)
    scheme = AjtaiScheme(ring, 1, n, seed=7)
    z = ring_vec_from_coeff_rows([[1] + [0] * (ring.d - 1) for _ in range(m)])
    c = ComR1CS.new(ring, [A_, B_, C_], z, 1, B, k, scheme)
    pparams = PlusParameters(lin=LinParameters(kappa=1, decomp=dparams(k=k)), B=B)
    jprover = PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams)

    tscheme, tc, tparams, tB = port_plus_setup(n, k, B=B)
    assert tc.x.cm_f == c.x.cm_f
    tpparams = TPlusParameters(lin=tparams, B=tB)
    tprover = TPlusProver(scheme=tscheme, M=tc.x.matrices, transcript=TPlusTranscript(TRING), params=tpparams)
    tverifier = TPlusVerifier(ring=TRING, M=tc.x.matrices, transcript=TPlusTranscript(TRING), params=tpparams)
    for _ in range(2):
        jblob = jser.serialize_plus_proof(ring, jprover.prove([c]))
        proof = tprover.prove([tc])
        assert tser.serialize_plus_proof(TRING, proof) == jblob
        assert tverifier.verify(proof)
