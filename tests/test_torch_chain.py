"""The port's IVC chain on the small fixture of tests/test_nifs.py::setup()
(Goldilocks, DP_GOLDILOCKS, kappa = 4, seed 7), on the CPU and with the
port alone: test_nifs.py::test_nifs_second_fold_and_rejection on the port
(its verifier accepts step 2, the folded witness opens the folded
commitment, and both tampered proofs are rejected by an exception of the
protocol, not an ``assert``, so that rejection holds under ``python -O``),
and the checkpoint/resume format: the accumulator and the witness's digits
after step 2, written and read back, prove step 3 again to the same bytes.
Tolerance: exact equality (integers mod q, proof bytes)."""

import copy
import functools

import pytest
import torch

import latticefold_torch.nifs as nifs
import latticefold_torch.nifs.linearization as linearization
from latticefold_torch import serialization as ser
from latticefold_torch.arith.ccs import CCCS, CCS, get_test_r1cs, get_test_z_split
from latticefold_torch.arith.witness import Witness
from latticefold_torch.commitment import AjtaiScheme
from latticefold_torch.nifs.decomposition import DecompositionError
from latticefold_torch.nifs.folding import FoldingError
from latticefold_torch.nifs.linearization import LinearizationError
from latticefold_torch.params import DP_GOLDILOCKS
from latticefold_torch.rings import ops
from latticefold_torch.rings.construct import get_ring
from latticefold_torch.sumcheck import SumcheckError
from latticefold_torch.transcript import Transcript

PROTOCOL_ERRORS = (LinearizationError, DecompositionError, FoldingError, SumcheckError)


@functools.lru_cache(maxsize=None)
def _setup():
    ring = get_ring("goldilocks")
    dp = DP_GOLDILOCKS
    ccs = CCS.from_r1cs_padded(ring, get_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = get_test_z_split(ring, 3)
    scheme = AjtaiScheme(ring, 4, len(w_host) * dp.L, seed=7, device="cpu")
    wit = Witness.from_w_ccs(ring, dp, ops.to_device(ring, w_host, "cpu"), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = linearization.prove(cm_i, wit, Transcript(ring), ccs)
    return dict(ring=ring, dp=dp, ccs=ccs, scheme=scheme, wit=wit, cm_i=cm_i, acc=acc)


def _prove(s, acc, w_acc):
    return nifs.prove(acc, w_acc, s["cm_i"], s["wit"], Transcript(s["ring"]), s["ccs"], s["scheme"], s["dp"])


def _verify(s, acc, proof):
    return nifs.verify(acc, s["cm_i"], proof, Transcript(s["ring"]), s["ccs"], s["dp"])


@functools.lru_cache(maxsize=None)
def _chain(steps):
    """[(acc_i, w_i, proof_i)] for i = 1..steps, and the checkpoint bytes of
    (acc_2, w_2.f_coeff)."""
    s = _setup()
    acc, w_acc, out, checkpoint = s["acc"], s["wit"], [], None
    for i in range(1, steps + 1):
        acc, w_acc, proof = _prove(s, acc, w_acc)
        out.append((acc, w_acc, proof))
        if i == 2:
            checkpoint = (ser.serialize_lcccs(s["ring"], acc), ser.serialize_witness_f(s["ring"], w_acc.f_coeff))
    return out, checkpoint


def test_port_verifier_accepts_the_second_step():
    s = _setup()
    (folded, _, proof), (folded2, w2, proof2) = _chain(3)[0][:2]
    # the verifier replays the chain from the bootstrap accumulator
    v1 = _verify(s, s["acc"], proof)
    v2 = _verify(s, v1, proof2)
    for f in ("r", "v", "u", "x_w", "h"):
        assert getattr(v1, f) == getattr(folded, f), f
        assert getattr(v2, f) == getattr(folded2, f), f
    assert v2.cm == folded2.cm
    assert w2.commit(s["scheme"]) == folded2.cm
    # the second step's inputs are not a first step's: the folded witness
    # has coefficients of both signs, the accumulator a non-trivial h
    ring = s["ring"]
    coeffs = [int(v) for v in ring.fq.decode(w2.f_coeff.numpy()).reshape(-1)]
    assert any(v > ring.q // 2 for v in coeffs) and any(1 < v <= ring.q // 2 for v in coeffs)
    assert folded.h != ring.one()


def _tamper_theta(ring, proof):
    proof.folding_proof.theta_s[0][0] = ring.radd(proof.folding_proof.theta_s[0][0], ring.one())


def _tamper_lin_u(ring, proof):
    proof.linearization_proof.u[0] = ring.radd(proof.linearization_proof.u[0], ring.one())


@pytest.mark.parametrize("tamper", [_tamper_theta, _tamper_lin_u], ids=["theta", "linearization_u"])
def test_port_verifier_rejects_tampered_proof(tamper):
    s = _setup()
    proof = _prove(s, s["acc"], s["wit"])[2]
    bad = copy.deepcopy(proof)
    tamper(s["ring"], bad)
    with pytest.raises(PROTOCOL_ERRORS):
        _verify(s, s["acc"], bad)
    _verify(s, s["acc"], proof)  # the untouched proof still verifies


def test_checkpoint_resume_gives_the_same_step():
    s = _setup()
    ring = s["ring"]
    chain, (acc_bytes, f_bytes) = _chain(3)
    acc2 = ser.deserialize_lcccs(ring, acc_bytes)
    assert ser.serialize_lcccs(ring, acc2) == acc_bytes
    f_coeff = ser.deserialize_witness_f(ring, f_bytes, "cpu")
    assert f_coeff.device.type == "cpu" and f_coeff.dtype == torch.int64
    assert torch.equal(f_coeff, chain[1][1].f_coeff)
    w2 = Witness.from_f_coeff(ring, s["dp"], f_coeff, n_pad=s["ccs"].m)
    assert torch.equal(w2.f, chain[1][1].f) and torch.equal(w2.w_ccs, chain[1][1].w_ccs)
    folded3, w3, proof3 = _prove(s, acc2, w2)
    assert ser.serialize_proof(ring, proof3) == ser.serialize_proof(ring, chain[2][2])
    assert ser.serialize_lcccs(ring, folded3) == ser.serialize_lcccs(ring, chain[2][0])
    assert w3.commit(s["scheme"]) == folded3.cm
