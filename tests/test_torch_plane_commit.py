"""latticefold_torch's byte-plane batch commit (rings/plane_commit.py,
AjtaiScheme.commit_batch_fused / commit_batch_cm, and the plain byte-plane
route of rings/mxu.py) against latticefold_tpu, on the CPU, where the
port's wrappers run their kernels' plain versions and the JAX package's
Pallas commit runs interpreted.

Shapes are tests/test_arith.py's (n = 640 in two 256-term slices plus a
tail, kappa 2, Nb 3; ``_K_SLICE`` set to 256 in both packages), and Stark
at n 64, kappa 2, Nb 2. Kernels A and B themselves run only on the card,
where chip_smoke.py holds them against these plain versions.

Tolerance: exact equality (0) of limbs, planes and plane products -- every
value is an integer."""

import numpy as np
import pytest
import torch

import latticefold_tpu.rings.pallas_commit as pc
from latticefold_torch import convert
from latticefold_torch.commitment import AjtaiScheme as TScheme
from latticefold_torch.rings import mxu as tmxu
from latticefold_torch.rings import plane_commit as tpc
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu.commitment import AjtaiScheme
from latticefold_tpu.rings.construct import get_ring

SLICE = 256
N, KAPPA, NB = 640, 2, 3


def witness_cm(ring, seed, n, Nb):
    """Component-major witness limbs [ncomp, n, e, Nb, nl] below every q."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=(ring.ncomp, n, ring.e, Nb, ring.nl), dtype=np.uint64)
    limbs = limbs.astype(np.uint32)
    limbs[..., -1] >>= 6
    return limbs


@pytest.fixture(scope="module")
def jax_fused():
    """Per ring: the JAX scheme, witness, fused planes and fused commit with
    2 + 1 slices (Pallas interpreted), computed once."""
    old = pc._K_SLICE
    pc._K_SLICE = SLICE
    try:
        out = {}
        for name in ("goldilocks", "frog", "babybear"):
            ring = get_ring(name)
            scheme = AjtaiScheme(ring, KAPPA, N, seed=5)
            fcm = witness_cm(ring, 11, N, NB)
            want = np.asarray(scheme.commit_batch_fused(fcm))
            out[name] = (scheme, fcm, scheme._fused_planes, want)
        return out
    finally:
        pc._K_SLICE = old


@pytest.fixture
def small_slices(monkeypatch):
    monkeypatch.setattr(tpc, "_K_SLICE", SLICE)
    monkeypatch.setattr(pc, "_K_SLICE", SLICE)


def port_scheme(name, scheme):
    return convert.ajtai_scheme(tget_ring(name), np.asarray(scheme.matrix), "cpu")


@pytest.mark.parametrize("name", ["goldilocks", "frog", "babybear"])
def test_fused_planes_match_jax_precompute(name, jax_fused, small_slices):
    scheme, _, want, _ = jax_fused[name]
    got = port_scheme(name, scheme)._fused_planes
    assert got.rows == want.rows
    assert got.lhs_i8.dtype == torch.int8 and np.array_equal(got.lhs_i8.numpy(), np.asarray(want.lhs_i8))
    assert got.sM.dtype == torch.int32 and np.array_equal(got.sM.numpy(), np.asarray(want.sM))


@pytest.mark.parametrize("name", ["goldilocks", "frog", "babybear"])
def test_commit_batch_fused_matches_jax(name, jax_fused, small_slices):
    """Three slices (256, 256, 128): the cross-slice sums and the ragged tail."""
    scheme, fcm, _, want = jax_fused[name]
    got = port_scheme(name, scheme).commit_batch_fused(convert.tensor(fcm, "cpu"))
    assert np.array_equal(convert.to_numpy(got), want)


@pytest.mark.parametrize("name", ["goldilocks", "frog", "babybear"])
def test_plane_dot_matches_fused_slice(name, jax_fused, small_slices):
    """Kernel A's plain version against ``_fused_slice`` (the Pallas dot,
    interpreted) on the first slice and on the ragged last one."""
    scheme, fcm, pre, _ = jax_fused[name]
    ring = get_ring(name)
    w2d = fcm.reshape(ring.ncomp, N, -1)
    tpre = port_scheme(name, scheme)._fused_planes
    tw2d = convert.tensor(fcm, "cpu").reshape(ring.ncomp, N, -1)
    for lo, hi in ((0, SLICE), (2 * SLICE, N)):
        want = np.asarray(pc._fused_slice(ring, pre.lhs_i8[:, :, lo:hi], w2d[:, lo:hi], hi - lo))
        got = tpc.plane_dot(tpre.lhs_i8[:, :, lo:hi], tw2d[:, lo:hi])
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["goldilocks", "frog", "babybear"])
def test_commit_batch_cm_and_plain_route_match_jax(name, jax_fused):
    """``commit_batch_cm`` (the commit kernel's path) and the plain
    byte-plane route ``mxu.ajtai_commit_cm`` (with its planes equal to the
    JAX package's) against JAX ``commit_batch_cm``."""
    scheme, fcm, _, _ = jax_fused[name]
    want = np.asarray(scheme.commit_batch_cm(fcm))
    tscheme = port_scheme(name, scheme)
    f = convert.tensor(fcm, "cpu")
    assert np.array_equal(convert.to_numpy(tscheme.commit_batch_cm(f)), want)
    planes = tmxu.ajtai_precompute(tscheme.ring, tscheme.matrix)
    assert np.array_equal(planes.numpy(), np.asarray(scheme._mxu_planes))
    assert np.array_equal(convert.to_numpy(tmxu.ajtai_commit_cm(tscheme.ring, planes, f)), want)


def test_stark_fused_matches_jax_cm_and_commit_kernel_path():
    """Stark (nl = 8, e = 1) at n 64, kappa 2, Nb 2: the fused route against
    JAX ``commit_batch_cm`` and against the port's commit-kernel path."""
    ring = get_ring("stark")
    scheme = AjtaiScheme(ring, 2, 64, seed=5)
    fcm = witness_cm(ring, 23, 64, 2)
    want = np.asarray(scheme.commit_batch_cm(fcm))
    tscheme = port_scheme("stark", scheme)
    f = convert.tensor(fcm, "cpu")
    got = convert.to_numpy(tscheme.commit_batch_fused(f))
    assert np.array_equal(got, want)
    assert np.array_equal(got, convert.to_numpy(tscheme.commit_batch_cm(f)))
    planes = tmxu.ajtai_precompute(tscheme.ring, tscheme.matrix)
    assert np.array_equal(convert.to_numpy(tmxu.ajtai_commit_cm(tscheme.ring, planes, f)), want)


def test_fused_equals_commit_kernel_path_per_slice_count(small_slices):
    """One slice, a ragged single slice and five slices give the commit
    kernel path's limbs (Goldilocks, seeded scheme)."""
    ring = tget_ring("goldilocks")
    for n in (SLICE, 100, 5 * SLICE - 3):
        tscheme = TScheme(ring, 2, n, seed=3, device="cpu")
        f = convert.tensor(witness_cm(ring, n, n, 2), "cpu")
        assert torch.equal(tscheme.commit_batch_fused(f), tscheme.commit_batch_cm(f))
        assert tscheme._fused_planes.sM.shape == (ring.ncomp, -(-n // SLICE), tscheme._fused_planes.lhs_i8.shape[1])


def test_wrappers_refuse_unknown_modes():
    lhs = torch.zeros((1, 32, 8), dtype=torch.int8)
    w = torch.zeros((1, 8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="no mode"):
        tpc.plane_dot(lhs, w, "v3")


@pytest.mark.parametrize("c,mpad,ks,L", [
    (8, 224, 1 << 15, 96),  # bench b16
    (8, 224, 1 << 15, 384),  # bench b64
    (16, 576, 1 << 15, 248),  # Stark's fold commit
    (8, 224, 16384, 63),  # BabyBear's fold commit
    (1, 32, 100, 2),  # a slice shorter than one split
])
def test_split_k_fills_the_card_without_short_splits(c, mpad, ks, L):
    """Kernel A's K splits: at least 8 blocks per SM of a 132-SM card where
    K allows, and no split shorter than _MIN_SPLIT_K unless K is."""
    tiles = c * -(-mpad // 64) * -(-L // 16)
    ksplit = tpc.split_k(tiles, ks, sms=132)
    assert ksplit >= 1
    assert tiles * ksplit >= 8 * 132 or ksplit == max(1, ks // tpc._MIN_SPLIT_K)
    assert ksplit == 1 or ks // ksplit >= tpc._MIN_SPLIT_K
