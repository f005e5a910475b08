"""The port's big-m fold path against the JAX package's: the weight tensor,
the round-J expansion, the grouped folding preparation and one W-tensor
round message, each on seeded tables, then the tests' small Goldilocks
fixture (tests/test_nifs.py::setup(), kappa 4, seed 7) folded on the big-m
path by both packages, forced on as tests/test_nifs.py::
test_bigm_folding_path_proof_identical forces it (the JAX package by its
environment knobs, the port by ``big_m=True, expand_nvars=2``), and the
rule that picks the path.

The JAX helpers run as the JAX package's own tests run them: jitted on the
CPU, with the round kernel eagerly (under ``jax.disable_jit()``) where a
jitted one would take a compile per chunk count. The comparison of whole
proofs with the JAX prover's big-m fold is slow-marked (its compiles);
tier-1 holds the port's big-m proof to its own standard proof, which
tests/test_torch_nifs.py holds to the JAX prover's. Tolerance: exact
equality -- every value is an integer mod q, and the proofs must be the
same bytes."""

import jax
import numpy as np
import pytest
import torch

import latticefold_torch.nifs as tnifs
import latticefold_torch.nifs.folding as tfolding
import latticefold_torch.nifs.linearization as tlinearization
import latticefold_torch.rings.ops as trops
import latticefold_torch.sumcheck as tsc
import latticefold_tpu.nifs as nifs
import latticefold_tpu.nifs.folding as folding
import latticefold_tpu.nifs.linearization as linearization
import latticefold_tpu.rings.ops as rops
import latticefold_tpu.sumcheck as sc
from latticefold_torch import convert
from latticefold_torch import params as tparams
from latticefold_torch import serialization as tser
from latticefold_torch.arith.ccs import CCCS as TCCCS
from latticefold_torch.arith.ccs import CCS as TCCS
from latticefold_torch.arith.ccs import get_test_r1cs as tget_test_r1cs
from latticefold_torch.arith.ccs import get_test_z_split as tget_test_z_split
from latticefold_torch.arith.witness import Witness as TWitness
from latticefold_torch.commitment import AjtaiScheme as TScheme
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_torch.transcript import Transcript as TTranscript
from latticefold_tpu import params
from latticefold_tpu.arith.ccs import CCCS, CCS, get_test_r1cs, get_test_z_split
from latticefold_tpu.arith.witness import Witness
from latticefold_tpu.commitment import AjtaiScheme
from latticefold_tpu.rings.construct import get_ring
from latticefold_tpu.serialization import serialize_proof
from latticefold_tpu.transcript import Transcript

KAPPA = 4
NAME = "goldilocks"


def rand_limbs(ring, shape, rng):
    """Canonical F_q values (valid Montgomery values too) as uint32 limbs
    [*shape, nl]."""
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (ring.nl,), dtype=np.uint64)
    limbs[..., -1] %= np.uint64(ring.q >> (32 * (ring.nl - 1)))
    return limbs.astype(np.uint32)


def rand_k(ring, rng, n):
    """``n`` seeded K elements (tuples of e ints below q)."""
    return [tuple(int(v) % ring.q for v in rng.integers(0, 1 << 62, size=ring.e)) for _ in range(n)]


def same(torch_out, jax_out):
    return np.array_equal(convert.to_numpy(torch_out), np.asarray(jax_out))


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_w_tensor_matches_jax(j):
    ring, tring = get_ring(NAME), tget_ring(NAME)
    chals = rand_k(ring, np.random.default_rng(40 + j), j)
    got = tsc._w_tensor(tring, chals, "cpu")
    assert tuple(got.shape) == (1 << j, ring.e, ring.nl)
    assert same(got, sc._w_tensor_dev(ring, chals))


@pytest.mark.parametrize("j", [1, 3])
def test_bigm_expand_matches_jax(j):
    """The round-J expansion out[x] = sum_y W[y] orig[x 2^J + y] on seeded
    compact rows [2K, tau, 2^(J+2), ncomp, nl]."""
    ring, tring = get_ring(NAME), tget_ring(NAME)
    rng = np.random.default_rng(50 + j)
    fhat5 = rand_limbs(ring, (4, ring.tau, 4 << j, ring.ncomp), rng)
    chals = rand_k(ring, rng, j)
    want = sc._bigm_expand(ring, fhat5, j, sc._w_tensor_dev(ring, chals))
    got = tsc._bigm_expand(tring, convert.tensor(fhat5, "cpu"), j, tsc._w_tensor(tring, chals, "cpu"))
    assert tuple(got.shape) == (4 * ring.tau, 4, ring.ncomp, ring.e, ring.nl)
    assert same(got, want)


@pytest.mark.parametrize("group", [4, 3], ids=["group4", "group3_ragged"])
def test_prepare_folding_parts_grouped_matches_jax(group):
    """Five expanded rows from seeded f-hat rows, z vectors, eq tables and
    challenges on the fixture's CCS (2K = 8: group 3 leaves a ragged last
    group and splits one group across the two halves)."""
    ring, tring = get_ring(NAME), tget_ring(NAME)
    dp = params.DP_GOLDILOCKS_B16
    ccs = CCS.from_r1cs_padded(ring, get_test_r1cs(ring), W=4, L=dp.L)
    tccs = TCCS.from_r1cs_padded(tring, tget_test_r1cs(tring), W=4, L=dp.L)
    rng = np.random.default_rng(60 + group)
    twoK, m = 2 * dp.K, ccs.m
    fh = rand_limbs(ring, (twoK, ring.tau, m, ring.ncomp), rng)
    z = rand_limbs(ring, (twoK, ccs.n, ring.ncomp, ring.e), rng)
    eqs = [rand_limbs(ring, (m, ring.ncomp, ring.e), rng) for _ in range(3)]
    alphas, zetas = (rand_limbs(ring, (twoK, ring.e), rng) for _ in range(2))
    want = folding.prepare_folding_parts_grouped(ring, dp.K, fh, z, ccs, *eqs, alphas, zetas, group=group)
    t = [convert.tensor(a, "cpu") for a in (fh, z, *eqs, alphas, zetas)]
    got = tfolding.prepare_folding_parts_grouped(tring, dp.K, t[0], t[1], tccs, *t[2:5], t[5], t[6], group=group)
    assert tuple(got.shape) == (5, m, ring.ncomp, ring.e, ring.nl)
    assert same(got, want)
    # and the standard path's first five rows are these
    std = tfolding.prepare_folding_mles_streaming(tring, dp.K, t[0], t[1], tccs, *t[2:5], t[5], t[6])
    assert got.equal(std[:5])


def _mix_comb(rops_mod, ring):
    """A degree-2 comb that reads every row: vals[0] * sum(vals[1:])."""
    return lambda vals, consts: rops_mod.ring_mul(ring, vals[0], rops_mod.ring_sum(ring, vals[1:], 0))


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_bigm_round_message_matches_jax(n_chunks):
    """One W-tensor round message (round j = 2 of 5 variables, 2K = 4, a
    degree-2 comb over all 5 + 2K tau rows) against JAX ``_bigm_round_fn``;
    the port's chunk of S / (2 n_chunks) pairs matches the JAX kernel's
    n_chunks. The folding comb itself runs on this path in
    test_bigm_fold_matches_jax_and_standard."""
    ring, tring = get_ring(NAME), tget_ring(NAME)
    twoK, j, S = 4, 2, 8
    rng = np.random.default_rng(70 + n_chunks)
    cur5 = rand_limbs(ring, (5, S, ring.ncomp, ring.e), rng)
    fhat5 = rand_limbs(ring, (twoK, ring.tau, S << j, ring.ncomp), rng)
    chals = rand_k(ring, rng, j)
    with jax.disable_jit():
        comb = sc.CombFn(ring, _mix_comb(rops, ring), key="mix")
        want = sc._bigm_round_fn(comb, 2, j, n_chunks)(cur5, fhat5, sc._w_tensor_dev(ring, chals), ())
    got = tsc._bigm_round_evs(tring, _mix_comb(trops, tring), 2, convert.tensor(cur5, "cpu"),
                              convert.tensor(fhat5, "cpu"), j, tsc._w_tensor(tring, chals, "cpu"), (),
                              chunk_pairs=S // (2 * n_chunks))
    assert tuple(got.shape) == (3, ring.ncomp, ring.e, ring.nl)
    assert same(got, want)


def _port_fixture():
    dp = tparams.DP_GOLDILOCKS
    ring = tget_ring(NAME)
    ccs = TCCS.from_r1cs_padded(ring, tget_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = tget_test_z_split(ring, 3)
    scheme = TScheme(ring, KAPPA, len(w_host) * dp.L, seed=7, device="cpu")
    wit = TWitness.from_w_ccs(ring, dp, trops.to_device(ring, w_host, "cpu"), n_pad=ccs.m)
    cm_i = TCCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = tlinearization.prove(cm_i, wit, TTranscript(ring), ccs)
    return dp, ring, ccs, scheme, wit, cm_i, acc


def _port_folds():
    """The small fixture folded by the port on the standard path and forced
    onto the big-m path (m 32: 5 variables, J = 3 W-tensor rounds)."""
    dp, ring, ccs, scheme, wit, cm_i, acc = _port_fixture()
    std = tnifs.prove(acc, wit, cm_i, wit, TTranscript(ring), ccs, scheme, dp, big_m=False)
    big = tnifs.prove(acc, wit, cm_i, wit, TTranscript(ring), ccs, scheme, dp, big_m=True, expand_nvars=2)
    return dp, ring, ccs, scheme, cm_i, acc, std, big


def test_bigm_fold_matches_standard():
    """The port's big-m proof, folded accumulator and folded witness are its
    standard path's, byte for byte; its verifier accepts the big-m proof
    and w0 opens the folded commitment. (The standard proof is the JAX
    prover's: tests/test_torch_nifs.py.)"""
    dp, ring, ccs, scheme, cm_i, acc, (tf_std, tw_std, tp_std), (tf_big, tw_big, tp_big) = _port_folds()
    assert tser.serialize_proof(ring, tp_big) == tser.serialize_proof(ring, tp_std)
    assert tser.serialize_lcccs(ring, tf_big) == tser.serialize_lcccs(ring, tf_std)
    assert tw_big.f.equal(tw_std.f)
    folded_v = tnifs.verify(acc, cm_i, tp_big, TTranscript(ring), ccs, dp)
    assert (folded_v.cm, folded_v.v, folded_v.r, folded_v.u) == (tf_big.cm, tf_big.v, tf_big.r, tf_big.u)
    assert tw_big.commit(scheme) == tf_big.cm


@pytest.mark.slow
def test_bigm_fold_matches_jax(monkeypatch):
    """The port's big-m proof against the JAX prover's on its big-m path,
    forced on as tests/test_nifs.py::test_bigm_folding_path_proof_identical
    forces it: the same proof and accumulator bytes and folded witness, and
    the JAX verifier accepts the port's proof. Slow-marked: the JAX big-m
    fold compiles its round kernels (about 1 min alone on the CPU, several
    under the tier-1 run's six workers); tier-1 holds the port's big-m
    proof to its standard one, and that one to the JAX prover's."""
    dp, ring, ccs, scheme, cm_i, acc, (tf_std, _, tp_std), (tf_big, tw_big, tp_big) = _port_folds()
    jring = get_ring(NAME)
    jdp = params.DP_GOLDILOCKS
    jccs = CCS.from_r1cs_padded(jring, get_test_r1cs(jring), W=4, L=jdp.L)
    _, x_ccs, w_host = get_test_z_split(jring, 3)
    jscheme = AjtaiScheme(jring, KAPPA, len(w_host) * jdp.L, seed=7)
    jwit = Witness.from_w_ccs(jring, jdp, rops.to_device(jring, w_host), n_pad=jccs.m)
    jcm_i = CCCS(cm=jwit.commit(jscheme), x_ccs=x_ccs)
    jacc, _ = linearization.prove(jcm_i, jwit, Transcript(jring), jccs)
    monkeypatch.setenv("LF_TPU_BIGM_LOGM", "1")
    monkeypatch.setenv("LF_TPU_BIGM_EXPAND", "2")
    jf, jw, jp = nifs.prove(jacc, jwit, jcm_i, jwit, Transcript(jring), jccs, jscheme, jdp)

    want = serialize_proof(jring, jp)
    assert tser.serialize_proof(ring, tp_big) == want
    assert tser.serialize_proof(ring, tp_std) == want
    assert tf_big.cm.vals == jf.cm.vals and (tf_big.r, tf_big.v, tf_big.u) == (jf.r, jf.v, jf.u)
    assert np.array_equal(convert.to_numpy(tw_big.f), np.asarray(jw.f))
    nifs.verify(jacc, jcm_i, tp_big, Transcript(jring), jccs, jdp)


def test_fold_witnesses_stream_matches_fold_witnesses():
    """The big-m path's row-at-a-time rho-fold equals the one-product form
    (and so the JAX package's, tests/test_torch_nifs.py)."""
    ring = tget_ring(NAME)
    rng = np.random.default_rng(31)
    f_all = convert.tensor(rand_limbs(ring, (6, 10, ring.ncomp, ring.e), rng), "cpu")
    rhos = convert.tensor(rand_limbs(ring, (6, ring.ncomp, ring.e), rng), "cpu")
    assert tfolding.fold_witnesses_stream(ring, f_all, rhos).equal(tfolding.fold_witnesses(ring, f_all, rhos))


# An NVIDIA H100 80GB HBM3's torch total_memory (bytes), as chip_smoke.py prints it
H100_MEMORY = 85017493504


@pytest.mark.parametrize("name,logm,big", [
    ("goldilocks", 15, False), ("goldilocks", 17, False), ("goldilocks", 18, True), ("goldilocks", 20, True),
    ("frog", 18, False), ("frog", 19, True),
    ("babybear", 14, False), ("babybear", 15, False), ("babybear", 16, True),
    ("stark", 15, False), ("stark", 16, True),
    ("unknown", 15, False), ("unknown", 16, True),
])
def test_big_m_rule(name, logm, big):
    """Which path ``prove`` takes when not told, at which m and ring, on an
    H100's memory: the standard path while its estimated peak stays under
    STANDARD_PEAK_SHARE of it."""
    assert tnifs.big_m_rule(name, 1 << logm, H100_MEMORY) is big


def test_use_big_m_reads_the_device():
    """On the CPU the rule reads the host's memory; the small fixture's m
    takes the standard path there."""
    cpu = torch.device("cpu")
    assert tnifs.device_memory(cpu) > 0
    assert tnifs.use_big_m(NAME, 32, cpu) is False
