"""The port's CCS additions against the JAX package's: R1CS.relax and
RelaxedR1CS on the cases of tests/test_arith.py::test_relaxed_r1cs, and the
fixtures get_test_dummy_r1cs_non_scalar,
get_test_dummy_degree_three_ccs_non_scalar and get_test_dummy_z_split_ntt
equal to the JAX functions' output for all four rings at small sizes.
Tolerance: exact (host ring elements are tuples of ints)."""

import pytest

import latticefold_torch.arith.ccs as tccs
import latticefold_tpu.arith.ccs as jccs
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu.rings.construct import get_ring

RINGS = ["goldilocks", "frog", "babybear", "stark"]


def _rows(m):
    return (m.nrows, m.ncols, m.rows)


def _ccs_fields(c):
    return (c.m, c.n, c.l, c.t, c.q, c.d, c.s, c.s_prime, c.S, c.c, [_rows(M) for M in c.M])


@pytest.mark.parametrize("name", RINGS)
def test_relaxed_r1cs(name):
    """A satisfying R1CS witness satisfies the trivial relaxation (u = 1,
    E = 0); with u != 1 it needs E = Az o Bz - u Cz."""
    ring = tget_ring(name)
    r1cs = tccs.get_test_r1cs(ring)
    z = tccs.get_test_z(ring, 3)
    relaxed = r1cs.relax()
    assert isinstance(relaxed, tccs.RelaxedR1CS) and (relaxed.u, relaxed.E) == (None, None)
    assert relaxed.check_relation(ring, z)
    z_bad = list(z)
    z_bad[2] = ring.embed_int(999)
    assert not relaxed.check_relation(ring, z_bad)

    u = ring.embed_int(7)
    Az, Bz, Cz = (M.mat_vec_host(z) for M in (r1cs.A, r1cs.B, r1cs.C))
    E = [ring.rsub(ring.rmul(a, b), ring.rmul(u, c)) for a, b, c in zip(Az, Bz, Cz)]
    assert tccs.RelaxedR1CS(l=r1cs.l, A=r1cs.A, B=r1cs.B, C=r1cs.C, u=u, E=E).check_relation(ring, z)
    E_bad = list(E)
    E_bad[0] = ring.radd(E_bad[0], ring.one())
    assert not tccs.RelaxedR1CS(l=r1cs.l, A=r1cs.A, B=r1cs.B, C=r1cs.C, u=u, E=E_bad).check_relation(ring, z)

    # the JAX package's relaxation of the same system says the same
    jring = get_ring(name)
    jr = jccs.get_test_r1cs(jring)
    assert jr.relax().check_relation(jring, z)
    assert jccs.RelaxedR1CS(l=jr.l, A=jr.A, B=jr.B, C=jr.C, u=u, E=E).check_relation(jring, z)
    assert not jccs.RelaxedR1CS(l=jr.l, A=jr.A, B=jr.B, C=jr.C, u=u, E=E_bad).check_relation(jring, z)


@pytest.mark.parametrize("name", RINGS)
def test_z_split_ntt_matches_jax(name):
    for x_len, wit_len in ((1, 4), (2, 3)):
        got = tccs.get_test_dummy_z_split_ntt(tget_ring(name), x_len, wit_len)
        assert got == jccs.get_test_dummy_z_split_ntt(get_ring(name), x_len, wit_len)
        one, statement, witness = got
        assert one == tget_ring(name).one() and len(statement) == x_len and len(witness) == wit_len


def _witness(ring, rows):
    """Ring elements with several distinct components: the ramp element of
    get_test_dummy_z_split_ntt plus small integers."""
    ramp = tccs.get_test_dummy_z_split_ntt(ring, 1, 1)[2][0]
    return [ring.radd(ramp, ring.embed_int(i + 2)) for i in range(rows)]


@pytest.mark.parametrize("name", RINGS)
def test_r1cs_non_scalar_matches_jax(name):
    ring, jring = tget_ring(name), get_ring(name)
    x_len, wit_len = 1, 4
    rows = x_len + wit_len + 1
    w = _witness(ring, rows)
    t = tccs.get_test_dummy_r1cs_non_scalar(ring, x_len, wit_len, rows, w)
    j = jccs.get_test_dummy_r1cs_non_scalar(jring, x_len, wit_len, rows, w)
    assert t.l == j.l == x_len
    for mat in ("A", "B", "C"):
        assert _rows(getattr(t, mat)) == _rows(getattr(j, mat)), mat
    # z = witness satisfies z o z = diag(w) z
    assert t.check_relation(ring, w)
    assert not t.check_relation(ring, w[:-1] + [ring.embed_int(5)])


@pytest.mark.parametrize("name", RINGS)
@pytest.mark.parametrize("L", [1, 2])
def test_degree_three_ccs_non_scalar_matches_jax(name, L):
    ring, jring = tget_ring(name), get_ring(name)
    x_len, wit_len = 1, 4
    w = _witness(ring, x_len + wit_len + 1)
    t = tccs.get_test_dummy_degree_three_ccs_non_scalar(ring, w, x_len, wit_len, L)
    j = jccs.get_test_dummy_degree_three_ccs_non_scalar(jring, w, x_len, wit_len, L)
    assert _ccs_fields(t) == _ccs_fields(j)
    assert (t.t, t.d, t.S, t.c) == (4, 3, [[0, 1, 2], [3]], [1, -1])
    t.sanity_check(L)
    # z = witness satisfies z o z o z = diag(w^2) z
    assert t.check_relation_host(w)
    assert not t.check_relation_host(w[:-1] + [ring.embed_int(5)])
