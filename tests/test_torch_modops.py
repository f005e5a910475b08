"""latticefold_torch.modops against latticefold_tpu.modops on the cases of
tests/test_modops.py (same seeds and shapes), for all four primes.

Tolerance: exact equality of canonical limbs -- every result is an integer
mod q."""

import random

import numpy as np
import pytest
import torch

import latticefold_torch.modops as tmo
import latticefold_tpu.modops as mo
from latticefold_tpu.rings.construct import BABYBEAR_Q, FROG_Q, GOLDILOCKS_Q, STARK_Q

PRIMES = [
    ("babybear", BABYBEAR_Q, 1),
    ("goldilocks", GOLDILOCKS_Q, 2),
    ("frog", FROG_Q, 2),
    ("stark", STARK_Q, 8),
]


def rand_ints(rng, q, n):
    return np.array([rng.randrange(q) for _ in range(n)], dtype=object)


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(torch_out, jax_out):
    return np.array_equal(torch_out.numpy().astype(np.uint32), np.asarray(jax_out))


@pytest.mark.parametrize("name,q,nl", PRIMES)
def test_add_sub_mont_match_jax(name, q, nl):
    rng = random.Random(42)
    m, tm = mo.Modulus(q, nl), tmo.Modulus(q, nl)
    n = 64
    a, b = m.encode(rand_ints(rng, q, n)), m.encode(rand_ints(rng, q, n))
    assert same(tmo.add(tm, t(a), t(b)), mo.add(m, a, b))
    assert same(tmo.sub(tm, t(a), t(b)), mo.sub(m, a, b))
    assert same(tmo.neg(tm, t(a)), mo.neg(m, a))
    am, bm = mo.to_mont(m, a), mo.to_mont(m, b)
    assert same(tmo.to_mont(tm, t(a)), am)
    assert same(tmo.from_mont(tm, t(np.asarray(am))), mo.from_mont(m, am))
    assert same(tmo.mont_mul(tm, t(np.asarray(am)), t(np.asarray(bm))), mo.mont_mul(m, am, bm))


@pytest.mark.parametrize("name,q,nl", PRIMES)
def test_sum_mod_matches_jax(name, q, nl):
    rng = random.Random(7)
    m, tm = mo.Modulus(q, nl), tmo.Modulus(q, nl)
    a = m.encode(rand_ints(rng, q, 37))
    assert same(tmo.sum_mod(tm, t(a), 0), mo.sum_mod(m, a, axis=0))


@pytest.mark.parametrize("name,q,nl", PRIMES[:3])
@pytest.mark.parametrize("b", [2, 4, 320, 1024])
def test_signed_digits_match_jax(name, q, nl, b):
    rng = random.Random(3)
    m, tm = mo.Modulus(q, nl), tmo.Modulus(q, nl)
    ndigits = 1
    while b**ndigits < q:
        ndigits += 1
    ndigits += 1
    vals = rand_ints(rng, q, 32)
    vals = np.concatenate([vals, np.array([0, 1, q - 1, q // 2, q // 2 + 1], dtype=object)])
    a = m.encode(vals)
    want = np.asarray(mo.signed_digits(m, a, b, ndigits)).astype(np.int64)
    got = tmo.signed_digits(tm, t(a), b, ndigits)
    assert np.array_equal(got.numpy(), want)
    f_want = mo.digits_to_field(m, mo.signed_digits(m, a, b, ndigits)[..., 0])
    assert same(tmo.digits_to_field(tm, got[..., 0]), f_want)
