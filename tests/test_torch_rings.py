"""latticefold_torch.rings.ops against latticefold_tpu.rings.ops: ext_mul /
ring_mul / scalar_mul / const_mul, add / sub / sum, the host <-> device
conversions, and both plain CRT/ICRT versions (``mat_apply``, the CPU
path, and ``crt_conv_plain``, the tensor-core kernel's own on its conv
matrix) against the JAX package's streamed VPU path and its fused Pallas
kernel (interpret mode on the CPU), at the shapes of tests/test_rings.py,
and for every ring (Stark included) against the JAX package's host oracle.
The CRT kernels themselves run only on the card: chip_smoke.py holds them
against both plain versions there.

Tolerance: exact equality of canonical limbs -- every result is an integer
mod q."""

import random

import numpy as np
import pytest
import torch

import latticefold_torch.rings.ops as trops
import latticefold_tpu.rings.ops as rops
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu.rings.construct import get_ring

RINGS = ["goldilocks", "frog", "stark", "babybear"]


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(torch_out, jax_out):
    return np.array_equal(torch_out.numpy().astype(np.uint32), np.asarray(jax_out))


def rand_mont_coeffs(ring, seed, N):
    rng = np.random.default_rng(seed)
    R = 1 << (32 * ring.nl)
    vals = rng.integers(0, 1 << 63, size=(N, ring.d), dtype=np.uint64).astype(object)
    vals %= ring.q
    mont = np.vectorize(lambda v: int(v) * R % ring.q, otypes=[object])(vals)
    return ring.fq.encode(mont)


def conv_crt(tring, coeffs):
    """``crt`` through ``crt_conv_plain``: [N, d, nl] -> [N, ncomp, e, nl]."""
    out = trops.crt_conv_plain(tring, "crt", coeffs)
    return out.reshape(out.shape[:-2] + (tring.ncomp, tring.e, tring.nl))


def conv_icrt(tring, x):
    """``icrt`` through ``crt_conv_plain``: [N, ncomp, e, nl] -> [N, d, nl]."""
    return trops.crt_conv_plain(tring, "icrt", x.reshape(x.shape[:-3] + (tring.d, tring.nl)))


@pytest.mark.parametrize("name", RINGS)
def test_ring_mul_matches_jax(name):
    ring, tring = get_ring(name), tget_ring(name)
    rng = random.Random(5)
    N = 9
    elts = [
        tuple(tuple(rng.randrange(ring.q) for _ in range(ring.e)) for _ in range(ring.ncomp))
        for _ in range(2 * N)
    ]
    a = rops.to_device(ring, elts[:N])
    b = rops.to_device(ring, elts[N:])
    assert same(trops.to_device(tring, elts[:N], "cpu"), a)
    assert same(trops.ring_mul(tring, t(a), t(b)), rops.ring_mul(ring, a, b))
    k = tuple(rng.randrange(ring.q) for _ in range(ring.e))
    kd = rops.k_to_device(ring, k)
    assert same(trops.k_to_device(tring, k, "cpu"), kd)
    assert same(trops.scalar_mul(tring, t(a), t(kd)), rops.scalar_mul(ring, a, kd))
    dd = rops.diag_to_device(ring, k)
    assert same(trops.diag_to_device(tring, k, "cpu"), dd)
    assert same(trops.ring_mul(tring, t(a), t(dd)), rops.ring_mul(ring, a, dd))
    c = kd[0]  # an F_q constant [nl]
    assert same(trops.const_mul(tring, t(a), t(c)), rops.const_mul(ring, a, c))
    assert same(trops.ring_add(tring, t(a), t(b)), rops.ring_add(ring, a, b))
    assert same(trops.ring_sub(tring, t(a), t(b)), rops.ring_sub(ring, a, b))
    assert same(trops.ring_sum(tring, t(a), 0), rops.ring_sum(ring, a, 0))
    assert list(trops.to_host(tring, t(a))) == elts[:N]


@pytest.mark.parametrize("name", RINGS)
def test_crt_plain_matches_vpu(name):
    """Both plain versions: ``mat_apply`` (the CPU path of crt / icrt) and
    ``crt_conv_plain`` (the tensor-core kernel's, on its conv matrix)."""
    ring, tring = get_ring(name), tget_ring(name)
    coeffs = rand_mont_coeffs(ring, 11, 37)
    want = rops.crt_vpu(ring, coeffs)
    assert same(trops.crt(tring, t(coeffs)), want)
    assert same(conv_crt(tring, t(coeffs)), want)
    want_i = rops.icrt_vpu(ring, want)
    assert same(trops.icrt(tring, t(np.asarray(want))), want_i)
    assert same(conv_icrt(tring, t(np.asarray(want))), want_i)


@pytest.mark.parametrize("name", RINGS[:2] + RINGS[3:])
def test_crt_plain_matches_pallas_interpret(name):
    """The fused Pallas kernel (the TPU kernel the CRT kernel replaces),
    interpreted on the CPU at the padded block of tests/test_rings.py."""
    from latticefold_tpu.rings import pallas_crt

    ring, tring = get_ring(name), tget_ring(name)
    coeffs = rand_mont_coeffs(ring, 13, 1093)
    want = pallas_crt.crt(ring, coeffs)
    assert same(trops.crt(tring, t(coeffs)), want)
    assert same(conv_crt(tring, t(coeffs)), want)
    want_i = pallas_crt.icrt(ring, want)
    assert same(trops.icrt(tring, t(np.asarray(want))), want_i)
    assert same(conv_icrt(tring, t(np.asarray(want))), want_i)


@pytest.mark.parametrize("name", RINGS)
def test_crt_plain_matches_host_oracle(name):
    """Every ring, Stark included, against the JAX package's host oracle
    ``Ring.crt_host`` / ``icrt_host`` (Python integers, no XLA compile)."""
    ring, tring = get_ring(name), tget_ring(name)
    rng = np.random.default_rng(17)
    N = 4
    coeffs = rng.integers(0, 1 << 63, size=(N, ring.d), dtype=np.uint64).astype(object) % ring.q
    R = 1 << (32 * ring.nl)
    x = t(ring.fq.encode(np.vectorize(lambda v: int(v) * R % ring.q, otypes=[object])(coeffs)))
    ntt = trops.crt(tring, x)  # [N, ncomp, e, nl]
    assert list(trops.to_host(tring, ntt)) == [ring.crt_host([int(v) for v in c]) for c in coeffs]
    assert conv_crt(tring, x).equal(ntt)
    back = trops.icrt(tring, ntt)
    assert conv_icrt(tring, ntt).equal(back)
    back = tring.fq.decode(back.numpy())  # Montgomery ints [N, d]
    rinv = pow(R, -1, ring.q)
    for i in range(N):
        want = ring.icrt_host(ring.crt_host([int(v) for v in coeffs[i]]))
        assert [int(v) * rinv % ring.q for v in back[i]] == want == [int(v) for v in coeffs[i]]


def test_cpu_tensors_never_launch_kernels():
    """A CPU tensor takes the plain version and leaves the launch counts alone."""
    from latticefold_torch import cuda

    tring = tget_ring("goldilocks")
    before = dict(cuda.LAUNCHES)
    x = t(rand_mont_coeffs(get_ring("goldilocks"), 1, 5))
    assert trops.icrt(tring, trops.crt(tring, x)).equal(x)
    assert cuda.LAUNCHES == before
