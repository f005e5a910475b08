"""The port's fold at moderate b against the JAX package's: the folding comb
(the range product as a balanced tree of 2b - 1 factors) at b 16
(DP_GOLDILOCKS_B16, a degree-32 folding sumcheck) and b 38
(DP_STARK_FOLDING, degree 76) on seeded tables, then the tests' small
fixture (tests/test_nifs.py::setup(), kappa 4, seed 7) folded at those
presets.

The JAX side runs as its own tests run it: eagerly, under
``jax.disable_jit()`` (tests/test_nifs.py:65-79 and :179-195; a jitted
degree-32 or degree-76 comb is an XLA:CPU compile bomb). Its folds at
these presets take many minutes eagerly on the CPU, so the comparisons of
whole proofs are slow-marked, as the JAX package's Stark one is; tier-1
keeps the combs and the port's own Goldilocks fold at b 16 (its verifier
accepts, the folded witness opens). Tolerance: exact equality -- every
value is an integer mod q, and the proofs must be the same bytes."""

import jax
import numpy as np
import pytest

import latticefold_torch.nifs.folding as tfolding
import latticefold_tpu.nifs as nifs
import latticefold_tpu.nifs.folding as folding
from latticefold_torch import convert
from latticefold_torch import serialization as tser
from latticefold_tpu import params
from latticefold_tpu.rings.construct import get_ring
from latticefold_tpu.serialization import serialize_lcccs, serialize_proof
from latticefold_tpu.transcript import Transcript
from latticefold_torch.rings.construct import get_ring as tget_ring
from test_torch_nifs import _check_port_accepts, _jax_fold, _port_fold


def rand_limbs(ring, shape, rng):
    """Canonical F_q values (valid Montgomery values too) as uint32 limbs
    [*shape, nl]."""
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (ring.nl,), dtype=np.uint64)
    limbs[..., -1] %= np.uint64(ring.q >> (32 * (ring.nl - 1)))
    return limbs.astype(np.uint32)


@pytest.mark.parametrize("name,preset", [
    ("goldilocks", "DP_GOLDILOCKS_B16"), ("goldilocks", "DP_STARK_FOLDING"),
    ("stark", "DP_GOLDILOCKS_B16"), ("stark", "DP_STARK_FOLDING"),
])
def test_folding_comb_matches_jax(name, preset):
    """The comb at b 16 and b 38 (with the preset's 2K) on seeded tables
    [5 + 2K tau, M, ncomp, e, nl] and mu challenges [2K, e, nl]."""
    dp = getattr(params, preset)
    ring, tring = get_ring(name), tget_ring(name)
    two_k = 2 * dp.K
    rng = np.random.default_rng(dp.b)
    vals = rand_limbs(ring, (5 + two_k * ring.tau, 2, ring.ncomp, ring.e), rng)
    mus = rand_limbs(ring, (two_k, ring.e), rng)
    with jax.disable_jit():
        want = folding._folding_comb(ring, two_k, ring.tau, dp.b).fn(vals, mus)
    got = tfolding._folding_comb(tring, two_k, tring.tau, dp.b, "cpu")(
        convert.tensor(vals, "cpu"), convert.tensor(mus, "cpu"))
    assert tuple(got.shape) == (2, ring.ncomp, ring.e, ring.nl)
    assert np.array_equal(convert.to_numpy(got), np.asarray(want))


def test_port_small_fold_b16_verifies():
    """The port's Goldilocks fold at DP_GOLDILOCKS_B16 (b 16, K 4): its
    verifier accepts and w0 opens the folded commitment."""
    _check_port_accepts(_port_fold("goldilocks", "DP_GOLDILOCKS_B16"))


@pytest.mark.slow
@pytest.mark.parametrize("name,preset", [("goldilocks", "DP_GOLDILOCKS_B16"), ("stark", "DP_STARK_FOLDING")])
def test_port_fold_matches_jax_moderate_b(name, preset):
    """The port's proof and folded accumulator are the JAX prover's, byte
    for byte, the JAX verifier accepts the port's proof, and the port's
    own verifier accepts it with w0 opening the folded commitment."""
    p = _port_fold(name, preset)
    _check_port_accepts(p)
    with jax.disable_jit():
        j = _jax_fold(name, preset)
        nifs.verify(j["acc"], j["cm_i"], p["proof"], Transcript(j["ring"]), j["ccs"], getattr(params, preset))
    assert tser.serialize_proof(p["ring"], p["proof"]) == serialize_proof(j["ring"], j["proof"])
    assert tser.serialize_lcccs(p["ring"], p["folded"]) == serialize_lcccs(j["ring"], j["folded"])
    assert np.array_equal(convert.to_numpy(p["w0"].f), np.asarray(j["w0"].f))
