"""latticefold_torch's witness pipeline, sparse SpMV and MLE engine against
latticefold_tpu, at the shapes of tests/test_arith.py and the NIFS fixture.

Tolerance: exact equality of canonical limbs -- every result is an integer
mod q."""

import random

import numpy as np
import pytest

import latticefold_torch.rings.ops as trops
import latticefold_tpu.rings.ops as rops
from latticefold_torch import convert
from latticefold_torch.arith import witness as twitness
from latticefold_torch.arith.ccs import CCS as TCCS
from latticefold_torch.arith.ccs import get_test_r1cs as tget_test_r1cs
from latticefold_torch.arith.ccs import get_test_z as tget_test_z
from latticefold_torch.params import DecompositionParams as TDecompositionParams
from latticefold_torch.poly import mle as tmle
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu.arith import witness
from latticefold_tpu.params import DecompositionParams
from latticefold_tpu.poly import mle
from latticefold_tpu.rings.construct import get_ring


def rand_ring_elts(ring, rng, n):
    return [
        tuple(tuple(rng.randrange(ring.q) for _ in range(ring.e)) for _ in range(ring.ncomp))
        for _ in range(n)
    ]


def same(torch_out, jax_out):
    return np.array_equal(convert.to_numpy(torch_out), np.asarray(jax_out))


@pytest.mark.parametrize("name,B,L,b,K", [
    ("goldilocks", 1 << 15, 5, 2, 15),
    ("frog", 1 << 8, 8, 2, 10),
])
def test_witness_pipeline_matches_jax(name, B, L, b, K):
    """Witness.from_w_ccs / from_f / from_f_coeff and gadget_recompose on the
    8-element witness of tests/test_arith.py::test_witness_roundtrip."""
    ring, tring = get_ring(name), tget_ring(name)
    dp, tdp = DecompositionParams(B, L, b, K), TDecompositionParams(B, L, b, K)
    w_host = rand_ring_elts(ring, random.Random(1), 8)
    wit = witness.Witness.from_w_ccs(ring, dp, rops.to_device(ring, w_host), n_pad=8 * L)
    twit = twitness.Witness.from_w_ccs(tring, tdp, trops.to_device(tring, w_host, "cpu"), n_pad=8 * L)
    keys = ("w_ccs", "f", "f_coeff", "f_hat")
    for k in keys:
        assert same(getattr(twit, k), getattr(wit, k)), k
    carried = convert.witness(tring, tdp, *(np.asarray(getattr(wit, k)) for k in keys), device="cpu")
    for k in keys:
        assert getattr(carried, k).equal(getattr(twit, k)), k
    assert twit.within_bound(B)
    assert list(trops.to_host(tring, twitness.gadget_recompose(tring, tdp, twit.f))) == w_host
    t2 = twitness.Witness.from_f(tring, tdp, twit.f, n_pad=8 * L)
    assert t2.f_hat.equal(twit.f_hat) and t2.w_ccs.equal(twit.w_ccs)
    t3 = twitness.Witness.from_f_coeff(tring, tdp, twit.f_coeff, n_pad=8 * L)
    assert t3.f.equal(twit.f)


def test_sparse_mat_vec_matches_host():
    """Device SpMV (and its cached transpose) against the host rows, on the
    padded test R1CS (tests/test_arith.py::test_ccs_relation)."""
    ring = tget_ring("goldilocks")
    ccs = TCCS.from_r1cs_padded(ring, tget_test_r1cs(ring), W=4, L=2)
    z = tget_test_z(ring, 3)
    assert ccs.check_relation_host(z)
    z_dev = trops.to_device(ring, z, "cpu")
    for M in ccs.M:
        assert list(trops.to_host(ring, M.mat_vec(z_dev))) == M.mat_vec_host(z)
        back = M.transpose().mat_vec(M.mat_vec(z_dev))
        want = M.transpose().mat_vec_host(M.mat_vec_host(z))
        assert list(trops.to_host(ring, back)) == want


def test_mle_matches_jax():
    """build_eq, fold/evaluate, pad_to and the subfield evaluation at the
    fixture's f_hat shape (tau = 3, m = 32)."""
    ring, tring = get_ring("goldilocks"), tget_ring("goldilocks")
    rng = random.Random(9)
    point = [tuple(rng.randrange(ring.q) for _ in range(ring.e)) for _ in range(5)]
    rs = mle.point_to_device(ring, point)
    trs = tmle.point_to_device(tring, point, "cpu")
    assert same(trs, rs)
    eq = mle.build_eq(ring, rs)
    assert same(tmle.build_eq(tring, trs), eq)
    tables = rops.to_device(ring, [rand_ring_elts(ring, rng, 32) for _ in range(2)])
    assert same(tmle.evaluate(tring, convert.tensor(np.asarray(tables), "cpu"), trs),
                mle.evaluate(ring, tables, rs))
    short = np.asarray(tables)[:, :20]
    assert same(tmle.pad_to(tring, convert.tensor(short, "cpu"), 32), mle.pad_to(ring, short, 32))
    sub = np.asarray(tables)[0, :, :, 0, :][None].repeat(3, axis=0)  # [tau=3, 32, c, nl]
    assert same(tmle.evaluate_subfield(tring, convert.tensor(sub, "cpu"), trs),
                mle.evaluate_subfield(ring, sub, rs))
