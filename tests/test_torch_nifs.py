"""The port's NIFS fold against the JAX package's, on the fixture of
tests/test_nifs.py::setup() (kappa = 4, seed 7): Goldilocks at DP_GOLDILOCKS
against the JAX prover, two steps of the IVC chain of
tests/test_nifs.py::test_nifs_second_fold_and_rejection (the second folds
the fresh instance into the first's folded accumulator and witness), the
same first fold with the transcript on the device
(``nifs.device_step.DeviceNIFS``; the JAX package's ``DeviceNIFS`` is an
XLA:CPU compile of hours and is not run), and
BabyBear (DP_BABYBEAR) and Stark (DP_STARK_E2E)
folded by the port alone -- its verifier accepts and the folded witness
opens the folded commitment -- with their comparison against the JAX prover
slow-marked, as the JAX package's own e2e tests of these two rings are (its
fold of them runs eagerly on the CPU).

Both folds of a comparison run once, in one test: the driver's xdist workers
would each rerun a shared fixture, and the JAX fold is the expensive part.
Tolerance: exact equality -- every value is an integer mod q, and the
serialized proofs must be the same bytes, from the port's serialization
module and from the JAX package's alike."""

import contextlib

import jax
import numpy as np
import pytest

import latticefold_torch.nifs as tnifs
import latticefold_torch.nifs.folding as tfolding
import latticefold_torch.nifs.linearization as tlinearization
import latticefold_torch.rings.ops as trops
import latticefold_tpu.nifs as nifs
import latticefold_tpu.nifs.folding as folding
import latticefold_tpu.nifs.linearization as linearization
import latticefold_tpu.rings.ops as rops
from latticefold_torch import convert
from latticefold_torch import serialization as tser
from latticefold_torch.arith.ccs import CCCS as TCCCS
from latticefold_torch.arith.ccs import CCS as TCCS
from latticefold_torch.arith.ccs import get_test_r1cs as tget_test_r1cs
from latticefold_torch.arith.ccs import get_test_z_split as tget_test_z_split
from latticefold_torch.arith.witness import Witness as TWitness
from latticefold_torch.commitment import AjtaiScheme as TScheme
from latticefold_torch.nifs.device_step import DeviceNIFS
from latticefold_torch import params as tparams
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_torch.transcript import Transcript as TTranscript
from latticefold_tpu.arith.ccs import CCCS, CCS, get_test_r1cs, get_test_z_split
from latticefold_tpu.arith.witness import Witness
from latticefold_tpu.commitment import AjtaiScheme
from latticefold_tpu import params
from latticefold_tpu.rings.construct import get_ring
from latticefold_tpu.serialization import serialize_lcccs, serialize_proof
from latticefold_tpu.transcript import Transcript

KAPPA = 4


def _jax_fold(name="goldilocks", preset="DP_GOLDILOCKS"):
    dp = getattr(params, preset)
    ring = get_ring(name)
    ccs = CCS.from_r1cs_padded(ring, get_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = get_test_z_split(ring, 3)
    scheme = AjtaiScheme(ring, KAPPA, len(w_host) * dp.L, seed=7)
    wit = Witness.from_w_ccs(ring, dp, rops.to_device(ring, w_host), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = linearization.prove(cm_i, wit, Transcript(ring), ccs)
    transcript = Transcript(ring)
    folded, w0, proof = nifs.prove(acc, wit, cm_i, wit, transcript, ccs, scheme, dp)
    return dict(ring=ring, ccs=ccs, scheme=scheme, wit=wit, cm_i=cm_i, acc=acc,
                folded=folded, w0=w0, proof=proof, dp=dp, transcript=transcript)


def _port_fold(name="goldilocks", preset="DP_GOLDILOCKS"):
    dp = getattr(tparams, preset)
    ring = tget_ring(name)
    ccs = TCCS.from_r1cs_padded(ring, tget_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = tget_test_z_split(ring, 3)
    scheme = TScheme(ring, KAPPA, len(w_host) * dp.L, seed=7, device="cpu")
    wit = TWitness.from_w_ccs(ring, dp, trops.to_device(ring, w_host, "cpu"), n_pad=ccs.m)
    cm_i = TCCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = tlinearization.prove(cm_i, wit, TTranscript(ring), ccs)
    # keep the witness arrays: the prover consumes the decomposed ones only
    arrays = {k: convert.to_numpy(getattr(wit, k)) for k in ("w_ccs", "f", "f_coeff", "f_hat")}
    folded, w0, proof = tnifs.prove(acc, wit, cm_i, wit, TTranscript(ring), ccs, scheme, dp)
    return dict(ring=ring, ccs=ccs, scheme=scheme, wit=wit, wit_arrays=arrays, cm_i=cm_i,
                acc=acc, folded=folded, w0=w0, proof=proof, dp=dp)


def _state(transcript):
    """A transcript's sponge state as (ints, index, absorbing)."""
    ints, index, absorbing = transcript.snapshot_state()
    return [int(v) for v in ints], index, absorbing


def _second_step(f, prove, transcript):
    """The chain's step 2: the fresh instance folded into (folded, w0)."""
    return prove(f["folded"], f["w0"], f["cm_i"], f["wit"], transcript(f["ring"]), f["ccs"], f["scheme"], f["dp"])


def _check_port_accepts(p):
    """The port's verifier accepts its proof and w0 opens the folded
    commitment."""
    folded_v = tnifs.verify(p["acc"], p["cm_i"], p["proof"], TTranscript(p["ring"]), p["ccs"], p["dp"])
    assert folded_v.cm == p["folded"].cm and folded_v.v == p["folded"].v
    assert (folded_v.r, folded_v.u) == (p["folded"].r, p["folded"].u)
    assert p["w0"].commit(p["scheme"]) == p["folded"].cm


def test_port_fold_matches_jax():
    j, p = _jax_fold(), _port_fold()
    # inputs: the seeded Ajtai matrix, the witness pipeline, the commitment
    assert np.array_equal(convert.to_numpy(p["scheme"].matrix), np.asarray(j["scheme"].matrix))
    for k, arr in p["wit_arrays"].items():
        assert np.array_equal(arr, np.asarray(getattr(j["wit"], k))), k
    assert p["cm_i"].cm.vals == j["cm_i"].cm.vals
    for f in ("r", "v", "u", "x_w", "h"):
        assert getattr(p["acc"], f) == getattr(j["acc"], f), f

    # every round message, v, u, theta and eta
    jp, pp = j["proof"], p["proof"]
    assert pp.linearization_proof.sumcheck.round_evals == jp.linearization_proof.sumcheck.round_evals
    assert pp.linearization_proof.v == jp.linearization_proof.v
    assert pp.linearization_proof.u == jp.linearization_proof.u
    for side in ("decomposition_proof_l", "decomposition_proof_r"):
        a, b = getattr(pp, side), getattr(jp, side)
        assert (a.u_s, a.v_s, a.x_s) == (b.u_s, b.v_s, b.x_s), side
        assert [y.vals for y in a.y_s] == [y.vals for y in b.y_s], side
    assert pp.folding_proof.sumcheck.round_evals == jp.folding_proof.sumcheck.round_evals
    assert pp.folding_proof.theta_s == jp.folding_proof.theta_s
    assert pp.folding_proof.eta_s == jp.folding_proof.eta_s
    assert serialize_proof(j["ring"], pp) == serialize_proof(j["ring"], jp)
    assert tser.serialize_proof(p["ring"], pp) == serialize_proof(j["ring"], jp)

    # the folded accumulator and witness
    assert p["folded"].cm.vals == j["folded"].cm.vals
    assert (p["folded"].r, p["folded"].v, p["folded"].u) == (j["folded"].r, j["folded"].v, j["folded"].u)
    assert np.array_equal(convert.to_numpy(p["w0"].f), np.asarray(j["w0"].f))

    # the JAX verifier and the port's own both accept the port's proof, and
    # the folded witness opens the folded commitment
    nifs.verify(j["acc"], j["cm_i"], pp, Transcript(j["ring"]), j["ccs"], params.DP_GOLDILOCKS)
    _check_port_accepts(p)

    # the same fold with the transcript on the device (plain permutation on
    # the CPU): the JAX proof bytes, folded instance and witness, and the
    # JAX transcript's state after it
    t = TTranscript(p["ring"])
    folded, w0, proof = DeviceNIFS(p["ccs"], p["dp"], p["scheme"]).prove(p["acc"], p["wit"], p["cm_i"], p["wit"], t)
    assert tser.serialize_proof(p["ring"], proof) == serialize_proof(j["ring"], jp)
    assert tser.serialize_lcccs(p["ring"], folded) == serialize_lcccs(j["ring"], j["folded"])
    assert (folded.x_w, folded.h) == (j["folded"].x_w, j["folded"].h)
    for k in ("f", "f_coeff", "f_hat", "w_ccs"):
        assert np.array_equal(convert.to_numpy(getattr(w0, k)), np.asarray(getattr(j["w0"], k))), k
    assert _state(t) == _state(j["transcript"])

    # step 2 on both sides: a folded accumulator (non-trivial r, v, u, x_w,
    # h) and a folded witness (coefficients over (-B, B)) go in
    jf2, jw2, jp2 = _second_step(j, nifs.prove, Transcript)
    pf2, pw2, pp2 = _second_step(p, tnifs.prove, TTranscript)
    want = serialize_proof(j["ring"], jp2)
    assert serialize_proof(j["ring"], pp2) == want
    assert tser.serialize_proof(p["ring"], pp2) == want
    assert tser.serialize_lcccs(p["ring"], pf2) == serialize_lcccs(j["ring"], jf2)
    assert (pf2.r, pf2.v, pf2.u, pf2.x_w, pf2.h) == (jf2.r, jf2.v, jf2.u, jf2.x_w, jf2.h)
    assert pf2.cm.vals == jf2.cm.vals
    assert np.array_equal(convert.to_numpy(pw2.f), np.asarray(jw2.f))
    assert np.array_equal(convert.to_numpy(pw2.f_coeff), np.asarray(jw2.f_coeff))
    nifs.verify(j["folded"], j["cm_i"], pp2, Transcript(j["ring"]), j["ccs"], params.DP_GOLDILOCKS)


@pytest.mark.parametrize("name,preset", [("babybear", "DP_BABYBEAR"), ("stark", "DP_STARK_E2E")])
def test_port_small_fold_verifies(name, preset):
    _check_port_accepts(_port_fold(name, preset))


@pytest.mark.slow
@pytest.mark.parametrize("name,preset", [("babybear", "DP_BABYBEAR"), ("stark", "DP_STARK_E2E")])
def test_port_fold_matches_jax_slow(name, preset):
    """The port's proof is the JAX prover's, byte for byte, and the JAX
    verifier accepts it. Stark's JAX fold runs eagerly, as
    tests/test_nifs.py::test_nifs_e2e_stark runs it (its nl = 8 protocol
    kernels do not compile in reasonable time on XLA:CPU)."""
    p = _port_fold(name, preset)
    ctx = jax.disable_jit() if name == "stark" else contextlib.nullcontext()
    with ctx:
        j = _jax_fold(name, preset)
        nifs.verify(j["acc"], j["cm_i"], p["proof"], Transcript(j["ring"]), j["ccs"], getattr(params, preset))
    assert p["cm_i"].cm.vals == j["cm_i"].cm.vals
    assert serialize_proof(j["ring"], p["proof"]) == serialize_proof(j["ring"], j["proof"])
    assert p["folded"].cm.vals == j["folded"].cm.vals
    assert np.array_equal(convert.to_numpy(p["w0"].f), np.asarray(j["w0"].f))
    _check_port_accepts(p)


def test_fold_witnesses_matches_jax_two_stage():
    """The port's one form of fold_witnesses against the JAX package's
    two-stage CPU form, at the fixture's shape (2K = 30 rows of 20 elements)."""
    ring, tring = get_ring("goldilocks"), tget_ring("goldilocks")
    rng = np.random.default_rng(29)
    f_all = rng.integers(0, 1 << 32, size=(30, 20, ring.ncomp, ring.e, ring.nl), dtype=np.uint64)
    f_all = f_all.astype(np.uint32)
    f_all[..., -1] >>= 1  # below q
    rhos = f_all[:, 0].copy()
    want = np.asarray(folding.fold_witnesses(ring, f_all, rhos))
    got = tfolding.fold_witnesses(tring, convert.tensor(f_all, "cpu"), convert.tensor(rhos, "cpu"))
    assert np.array_equal(convert.to_numpy(got), want)
