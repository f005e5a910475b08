"""latticefold_torch Ajtai commitments against latticefold_tpu: the seeded
matrix, the plain commit against the XLA byte-plane path
(``mxu.ajtai_commit_cm``) and the fused Pallas kernel
(``pallas_commit.ajtai_commit_fused``, interpreted on the CPU) at the shapes
of tests/test_arith.py, and Stark against the JAX commit its fold uses. The
commit kernel itself runs only on the card: chip_smoke.py holds it against
the plain version there.

Tolerance: exact equality of canonical limbs -- every result is an integer
mod q."""

import numpy as np
import pytest

import latticefold_torch.rings.ops as trops
from latticefold_torch import convert
from latticefold_torch.commitment import AjtaiScheme as TScheme
from latticefold_torch.rings import mxu as tmxu
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu.commitment import AjtaiScheme
from latticefold_tpu.rings.construct import get_ring


def rand_witness_limbs(ring, seed, shape):
    """Random limbs below every ring's q (the high limb's top bits cleared,
    as tests/test_arith.py does)."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=shape + (ring.nl,), dtype=np.uint64).astype(np.uint32)
    limbs[..., -1] >>= 6
    return limbs


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog", "stark"])
def test_scheme_matrix_matches_jax(name):
    ring = get_ring(name)
    want = np.asarray(AjtaiScheme(ring, 3, 512, seed=5).matrix)
    got = TScheme(tget_ring(name), 3, 512, seed=5, device="cpu").matrix
    assert np.array_equal(convert.to_numpy(got), want)


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_plain_commit_matches_xla_cm(name):
    """Shapes of test_ajtai_commit_cm_matches_batch: n = 512, kappa = 3, Nb = 4."""
    ring, tring = get_ring(name), tget_ring(name)
    n, kappa, Nb = 1 << 9, 3, 4
    scheme = AjtaiScheme(ring, kappa, n, seed=5)
    limbs = rand_witness_limbs(ring, 17, (n, Nb, ring.ncomp, ring.e))
    fcm = np.transpose(limbs, (2, 0, 3, 1, 4))
    want = np.asarray(scheme.commit_batch_cm(fcm))
    tscheme = convert.ajtai_scheme(tring, np.asarray(scheme.matrix), "cpu")
    got = tscheme.commit_batch(convert.tensor(limbs, "cpu"))
    assert np.array_equal(convert.to_numpy(got), want)
    one = tscheme.commit_device(convert.tensor(limbs[:, 0], "cpu"))
    assert np.array_equal(convert.to_numpy(one), want[:, 0])


@pytest.mark.parametrize("name", ["goldilocks", "frog", "babybear"])
def test_plain_commit_matches_fused_pallas(name, monkeypatch):
    """Shapes of test_ajtai_commit_fused_matches_cm (n = 640 in two 256-slices
    plus a tail, kappa = 2, Nb = 3), the Pallas kernel interpreted."""
    import latticefold_tpu.rings.pallas_commit as pc

    monkeypatch.setattr(pc, "_K_SLICE", 256)
    ring, tring = get_ring(name), tget_ring(name)
    n, kappa, Nb = 640, 2, 3
    scheme = AjtaiScheme(ring, kappa, n, seed=5)
    fcm = rand_witness_limbs(ring, 11, (ring.ncomp, n, ring.e, Nb))
    want = np.asarray(scheme.commit_batch_fused(fcm))
    f = np.ascontiguousarray(np.transpose(fcm, (1, 3, 0, 2, 4)))  # [n, Nb, c, e, nl]
    got = tmxu.ajtai_commit(tring, convert.tensor(np.asarray(scheme.matrix), "cpu"), convert.tensor(f, "cpu"))
    assert np.array_equal(convert.to_numpy(got), want)


def test_plain_commit_matches_jax_stark():
    """Stark (nl = 8, e = 1) at a small width: n = 64, kappa = 2, Nb = 2,
    against the JAX commit its fold uses (``AjtaiScheme.commit_device``,
    one witness at a time)."""
    ring, tring = get_ring("stark"), tget_ring("stark")
    n, kappa, Nb = 64, 2, 2
    scheme = AjtaiScheme(ring, kappa, n, seed=5)
    limbs = rand_witness_limbs(ring, 23, (n, Nb, ring.ncomp, ring.e))
    tscheme = convert.ajtai_scheme(tring, np.asarray(scheme.matrix), "cpu")
    got = convert.to_numpy(tscheme.commit_batch(convert.tensor(limbs, "cpu")))
    for b in range(Nb):
        assert np.array_equal(got[:, b], np.asarray(scheme.commit_device(limbs[:, b])))


@pytest.mark.parametrize("name", ["goldilocks", "frog", "babybear", "stark"])
def test_commit_plan_fits_shared_memory(name):
    """The commit kernel's tile at the fold's shapes (kappa by the 128-bit
    predicate at wit_len 4096, n = 4096 L, Nb = K - 1) fits the 48 KB that
    ``commit_plan`` sizes it for, with 4 nl bytes per F_q value, and the
    chunks cover n."""
    from latticefold_torch import params

    tring = tget_ring(name)
    dp = {"goldilocks": params.DP_GOLDILOCKS, "frog": params.DP_FROG,
          "babybear": params.DP_BABYBEAR, "stark": params.DP_STARK_E2E}[name]
    kappa = next(k for k in range(1, 64) if params.check_ring_modulus_128_bits_security(
        tring.q, tring.d, k, 4096, dp.B, dp.L))
    n, Nb = 4096 * dp.L, dp.K - 1
    nchunks, chunk, tn = tmxu.commit_plan(tring, kappa, n, Nb, sms=132)
    assert 1 <= tn <= 32
    assert tn * tring.e * (kappa + Nb) * 4 * tring.nl <= tmxu._SMEM_BYTES
    assert (nchunks - 1) * chunk < n <= nchunks * chunk


def test_commit_closed_form():
    """commit_ntt closed form: A[i][j] = diag(i n + j), f = 2 everywhere."""
    ring = tget_ring("goldilocks")
    n, kappa = 1 << 8, 9
    scheme = TScheme.identity_like(ring, kappa, n, device="cpu")
    cm = scheme.commit(trops.to_device(ring, [ring.embed_int(2)] * n, "cpu"))
    for i, x in enumerate(cm.vals):
        assert x == ring.embed_int((n * (2 * i * n + (n - 1))) % ring.q)
