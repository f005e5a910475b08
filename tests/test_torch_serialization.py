"""The port's serialization module against the JAX package's: the same
bytes for a proof, an LCCCS, a witness's f_coeff digits and a LatticeFold+
proof, and each module reads the other's bytes back to the same values.
Proofs and accumulators are the port's fold of the small fixture of
tests/test_nifs.py::setup() (Goldilocks) and, for all four rings (the
LatticeFold+ proof: Frog and Stark, its power-of-two rings), objects of
the same structure filled with random field elements made from a seed.
Tolerance: exact (bytes and integers)."""

import functools

import numpy as np
import pytest
import torch

import latticefold_torch.nifs as tnifs
import latticefold_torch.nifs.linearization as tlinearization
import latticefold_tpu.plus.cm as jcm
import latticefold_tpu.plus.decomp as jdecomp
import latticefold_tpu.plus.mlin as jmlin
import latticefold_tpu.plus.plus as jplus
import latticefold_tpu.plus.r1cs as jr1cs
import latticefold_tpu.plus.rgchk as jrgchk
import latticefold_tpu.plus.setchk as jsetchk
import latticefold_tpu.plus.sumcheck as jpsc
import latticefold_tpu.serialization as jser
import latticefold_torch.plus.cm as tcm
import latticefold_torch.plus.decomp as tdecomp
import latticefold_torch.plus.mlin as tmlin
import latticefold_torch.plus.plus as tplus
import latticefold_torch.plus.r1cs as tr1cs
import latticefold_torch.plus.rgchk as trgchk
import latticefold_torch.plus.setchk as tsetchk
import latticefold_torch.plus.sumcheck as tpsc
from latticefold_torch import serialization as ser
from latticefold_torch.arith.ccs import CCCS, CCS, LCCCS, Commitment, get_test_r1cs, get_test_z_split
from latticefold_torch.arith.witness import Witness
from latticefold_torch.commitment import AjtaiScheme
from latticefold_torch.nifs.decomposition import DecompositionProof
from latticefold_torch.nifs.folding import FoldingProof
from latticefold_torch.nifs.linearization import LinearizationProof
from latticefold_torch.params import DP_GOLDILOCKS
from latticefold_torch.rings import ops
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_torch.sumcheck import SumcheckProof
from latticefold_torch.transcript import Transcript
from latticefold_tpu.rings.construct import get_ring

RINGS = ["goldilocks", "frog", "babybear", "stark"]  # nl 2, 2, 1, 8; e 3, 4, 9, 1


@functools.lru_cache(maxsize=None)
def _fold():
    """The port's fold of the small Goldilocks fixture: (acc, folded, w0, proof)."""
    ring, dp = tget_ring("goldilocks"), DP_GOLDILOCKS
    ccs = CCS.from_r1cs_padded(ring, get_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = get_test_z_split(ring, 3)
    scheme = AjtaiScheme(ring, 4, len(w_host) * dp.L, seed=7, device="cpu")
    wit = Witness.from_w_ccs(ring, dp, ops.to_device(ring, w_host, "cpu"), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = tlinearization.prove(cm_i, wit, Transcript(ring), ccs)
    folded, w0, proof = tnifs.prove(acc, wit, cm_i, wit, Transcript(ring), ccs, scheme, dp)
    return acc, folded, w0, proof


class _Rand:
    """Random canonical field, K and ring elements of one ring."""

    def __init__(self, ring, seed):
        self.ring, self.rng = ring, np.random.default_rng(seed)

    def fq(self):
        return int.from_bytes(self.rng.bytes(4 * self.ring.nl + 8), "little") % self.ring.q

    def k(self):
        return tuple(self.fq() for _ in range(self.ring.e))

    def r(self):
        return tuple(self.k() for _ in range(self.ring.ncomp))

    def rv(self, n):
        return [self.r() for _ in range(n)]

    def cm(self, kappa):
        return Commitment(self.ring, self.rv(kappa))


def _rand_proof(g: _Rand, K=3, t=3, tau=2, kappa=2, rounds=4):
    lin = LinearizationProof(sumcheck=SumcheckProof([g.rv(4) for _ in range(rounds)]), v=g.rv(tau), u=g.rv(t))

    def dec():
        return DecompositionProof(u_s=[g.rv(t) for _ in range(K)], v_s=[g.rv(tau) for _ in range(K)],
                                  x_s=[g.rv(2) for _ in range(K)], y_s=[g.cm(kappa) for _ in range(K)])

    fold = FoldingProof(sumcheck=SumcheckProof([g.rv(5) for _ in range(rounds)]),
                        theta_s=[g.rv(tau) for _ in range(2 * K)], eta_s=[g.rv(t) for _ in range(2 * K)])
    return tnifs.LFProof(linearization_proof=lin, decomposition_proof_l=dec(),
                         decomposition_proof_r=dec(), folding_proof=fold)


def _rand_lcccs(g: _Rand, rounds=5):
    return LCCCS(r=[g.k() for _ in range(rounds)], v=g.rv(2), cm=g.cm(3), u=g.rv(3), x_w=g.rv(1), h=g.r())


def test_fold_proof_and_lcccs_bytes_match_jax():
    jring = get_ring("goldilocks")
    acc, folded, _, proof = _fold()
    ring = tget_ring("goldilocks")
    blob = ser.serialize_proof(ring, proof)
    assert blob == jser.serialize_proof(jring, proof)
    for a in (acc, folded):
        assert ser.serialize_lcccs(ring, a) == jser.serialize_lcccs(jring, a)
    # the JAX module's bytes, read by the port and written again
    assert ser.serialize_proof(ring, ser.deserialize_proof(ring, blob)) == blob
    assert ser.deserialize_proof(ring, blob) == proof
    acc_bytes = jser.serialize_lcccs(jring, folded)
    assert ser.serialize_lcccs(ring, ser.deserialize_lcccs(ring, acc_bytes)) == acc_bytes
    assert ser.deserialize_lcccs(ring, acc_bytes) == folded
    # and the port's bytes, read by the JAX module
    assert jser.serialize_proof(jring, jser.deserialize_proof(jring, blob)) == blob


def test_fold_witness_f_bytes_match_jax():
    w0 = _fold()[2]
    ring, jring = tget_ring("goldilocks"), get_ring("goldilocks")
    arr = w0.f_coeff.numpy().astype(np.uint32)
    blob = ser.serialize_witness_f(ring, w0.f_coeff)
    assert blob == jser.serialize_witness_f(jring, arr)
    back = ser.deserialize_witness_f(ring, blob, "cpu")
    assert back.dtype == torch.int64 and torch.equal(back, w0.f_coeff)
    assert np.array_equal(jser.deserialize_witness_f(jring, blob), arr)


@pytest.mark.parametrize("name", RINGS)
def test_random_proof_and_lcccs_bytes_match_jax(name):
    ring, jring = tget_ring(name), get_ring(name)
    g = _Rand(ring, 11)
    proof, acc = _rand_proof(g), _rand_lcccs(g)
    blob = ser.serialize_proof(ring, proof)
    assert blob == jser.serialize_proof(jring, proof)
    assert ser.deserialize_proof(ring, blob) == proof
    assert jser.serialize_proof(jring, ser.deserialize_proof(ring, blob)) == blob
    assert ser.serialize_proof(ring, jser.deserialize_proof(jring, blob)) == blob
    acc_bytes = ser.serialize_lcccs(ring, acc)
    assert acc_bytes == jser.serialize_lcccs(jring, acc)
    assert ser.deserialize_lcccs(ring, acc_bytes) == acc
    assert ser.serialize_lcccs(ring, jser.deserialize_lcccs(jring, acc_bytes)) == acc_bytes


@pytest.mark.parametrize("name", RINGS)
def test_random_witness_f_bytes_match_jax(name):
    ring, jring = tget_ring(name), get_ring(name)
    rng = np.random.default_rng(13)
    arr = rng.integers(0, 1 << 32, size=(5, ring.d, ring.nl), dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(arr.astype(np.int64))
    blob = ser.serialize_witness_f(ring, t)
    assert blob == jser.serialize_witness_f(jring, arr)
    assert torch.equal(ser.deserialize_witness_f(ring, blob, "cpu"), t)
    bad = t.clone()
    bad[0, 0, 0] = 1 << 32
    with pytest.raises(ser.SerializationError):
        ser.serialize_witness_f(ring, bad)
    bad[0, 0, 0] = -1
    with pytest.raises(ser.SerializationError):
        ser.serialize_witness_f(ring, bad)


@pytest.mark.parametrize("name", RINGS)
def test_writer_reader_elements_match_jax(name):
    ring, jring = tget_ring(name), get_ring(name)
    g = _Rand(ring, 17)
    ints = [0, 1, ring.q - 1] + [g.fq() for _ in range(5)]
    ks = [g.k() for _ in range(4)]
    rs = g.rv(3)
    w, jw = ser.Writer(ring), jser.Writer(jring)
    for wr in (w, jw):
        for v in ints:
            wr.fq(v)
        wr.k_vec(ks)
        wr.ring_vec(rs)
        wr.ring_elt(rs[0])
        wr.u32(0xFFFFFFFF)
    blob = w.getvalue()
    assert blob == jw.getvalue()
    assert len(blob) == 4 * ring.nl * (len(ints) + ring.e * len(ks) + ring.d * (len(rs) + 1)) + 12
    r = ser.Reader(ring, blob)
    assert [r.fq() for _ in ints] == ints
    assert r.k_vec() == ks and r.ring_vec() == rs and r.ring_elt() == rs[0]
    assert r.u32() == 0xFFFFFFFF


def _rand_plus_proof(g: _Rand, mods, L=2, Mlen=3, kappa=2, k=2, rounds=3):
    """A LatticeFold+ proof of the given package's types (``mods``: its
    plus modules), random coefficient lists from ``g``. Two calls with equal
    seeds give equal values."""
    psc, r1cs, setchk, rgchk, cm, decomp, mlin, plus = mods
    d = g.ring.d

    def c():
        return [g.fq() for _ in range(d)]

    def cv(n):
        return [c() for _ in range(n)]

    def sc(deg):
        return psc.SumcheckProof([cv(deg + 1) for _ in range(rounds)])

    def pairs(n):
        return [(c(), c()) for _ in range(n)]

    lproof = [r1cs.ComR1CSProof(sumcheck=sc(3), nvars=rounds, r=[g.fq() for _ in range(rounds)],
                                v=c(), va=c(), vb=c(), vc=c())]
    out = setchk.SetCheckOut(nvars=rounds, r=[g.fq() for _ in range(rounds)], sumcheck_proof=sc(3),
                             e=[[cv(d) for _ in range(k * L)] for _ in range(1 + Mlen)], b=cv(L))
    evals = [rgchk.DcomEvals(v=[g.fq() for _ in range(d)], a=[g.fq() for _ in range(1 + Mlen)],
                             b=cv(1 + Mlen), c=cv(1 + Mlen)) for _ in range(L)]
    fcoms = [rgchk.FComs(cm_f=cv(kappa), C_Mf=cv(kappa), cm_mtau=cv(kappa)) for _ in range(L)]
    dcom = rgchk.Dcom(evals=evals, fcoms=fcoms, out=out, dparams=rgchk.DecompParameters(b=d // 2, k=k, l=22))
    cmp = cm.CmProof(dcom=dcom, comh=[cv(kappa) for _ in range(L)], sumcheck_proofs=(sc(2), sc(2)),
                     evals=tuple([cm.InstanceEvals(groups=[cv(4) for _ in range(1 + Mlen)]) for _ in range(L)]
                                 for _ in range(2)))
    dproof = decomp.DecompProof(C=(cv(kappa), cv(kappa)), v=(pairs(1 + Mlen), pairs(1 + Mlen)))
    linb2x = mlin.LinB2X(cm_g=cv(kappa), ro=[(g.fq(), g.fq()) for _ in range(rounds)], vo=pairs(1 + Mlen))
    return plus.PlusProof(linb2x=linb2x, lproof=lproof, cmproof=cmp, dproof=dproof)


@pytest.mark.parametrize("name", ["frog", "stark"])
def test_random_plus_proof_bytes_match_jax(name):
    """A hand-built PlusProof: the port's writer gives the JAX writer's
    bytes for the same values, and both readers read them back to bytes
    the port's writer gives again."""
    ring, jring = tget_ring(name), get_ring(name)
    proof = _rand_plus_proof(_Rand(ring, 23), (tpsc, tr1cs, tsetchk, trgchk, tcm, tdecomp, tmlin, tplus))
    jproof = _rand_plus_proof(_Rand(ring, 23), (jpsc, jr1cs, jsetchk, jrgchk, jcm, jdecomp, jmlin, jplus))
    blob = ser.serialize_plus_proof(ring, proof)
    assert blob == jser.serialize_plus_proof(jring, jproof)
    assert blob[:12] == ser.MAGIC + b"PLUS"
    assert ser.deserialize_plus_proof(ring, blob) == proof
    assert ser.serialize_plus_proof(ring, jser.deserialize_plus_proof(jring, blob)) == blob
    with pytest.raises(ser.SerializationError):
        ser.deserialize_plus_proof(ring, blob[:8] + b"PLUZ" + blob[12:])


def test_bad_magic_raises():
    ring = tget_ring("goldilocks")
    acc_bytes = ser.serialize_lcccs(ring, _rand_lcccs(_Rand(ring, 19)))
    for read in (ser.deserialize_proof, ser.deserialize_lcccs, ser.deserialize_witness_f):
        with pytest.raises(ser.SerializationError):
            read(ring, b"X" + acc_bytes[1:])
