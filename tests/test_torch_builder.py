"""The port's R1CS builder (latticefold_torch.arith.builder) against the JAX
package's, on the cases of tests/test_builder.py (x^3 + x + 5 = y built by
hand) for all four rings: the same validity, the same sparse R1CS rows,
NotSatisfiedError at the same constraint index, and the same A/B swap.
Tolerance: exact (host ring elements are tuples of ints)."""

import pytest

import latticefold_torch.arith.builder as tb
import latticefold_tpu.arith.builder as jb
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_tpu.rings.construct import get_ring

RINGS = ["goldilocks", "frog", "babybear", "stark"]


def cubic_system(mod, ring):
    """x^3 + x + 5 = y: vars [y (public), one, x, t1 = x*x, t2 = t1*x]."""
    LC, Cn = mod.LinearCombination, mod.Constraint
    cs = mod.ConstraintSystem(ring, ninputs=1, nauxs=4)
    cs.add_constraint(Cn(LC.single_term(1, 2), LC.single_term(1, 2), LC.single_term(1, 3)))
    cs.add_constraint(Cn(LC.single_term(1, 3), LC.single_term(1, 2), LC.single_term(1, 4)))
    cs.add_constraint(Cn(LC([(1, 4), (1, 2), (5, 1)]), LC.single_term(1, 1), LC.single_term(1, 0)))
    return cs


def assignment(ring, x):
    emb = ring.embed_int
    return [emb(x**3 + x + 5)], [emb(1), emb(x), emb(x * x), emb(x**3)]


def _both(name):
    tring, jring = tget_ring(name), get_ring(name)
    return (tb, tring, cubic_system(tb, tring)), (jb, jring, cubic_system(jb, jring))


def _rows(m):
    return (m.nrows, m.ncols, m.rows)


@pytest.mark.parametrize("name", RINGS)
def test_builder_satisfied_on_both(name):
    for _, ring, cs in _both(name):
        assert cs.is_valid()
        assert (cs.nvars, cs.nconstraints) == (5, 3)
        cs.is_satisfied(*assignment(ring, 3))


@pytest.mark.parametrize("name", RINGS)
@pytest.mark.parametrize("var,index", [(3, 0), (4, 1), (0, 2)])
def test_builder_not_satisfied_same_index(name, var, index):
    """Corrupting t1, t2 or y fails the first, second or third constraint."""
    got = []
    for mod, ring, cs in _both(name):
        z = sum(assignment(ring, 3), [])
        z[var] = ring.embed_int(999)
        with pytest.raises(mod.NotSatisfiedError) as ei:
            cs.is_satisfied(z[:1], z[1:])
        got.append(ei.value.index)
    assert got == [index, index]


@pytest.mark.parametrize("name", RINGS)
def test_builder_bad_lengths_raise_value_error(name):
    for _, ring, cs in _both(name):
        pri, aux = assignment(ring, 3)
        with pytest.raises(ValueError):
            cs.is_satisfied(pri + pri, aux)
        with pytest.raises(ValueError):
            cs.is_satisfied(pri, aux[:-1])


@pytest.mark.parametrize("name", RINGS)
def test_builder_to_r1cs_same_matrices(name):
    (_, tring, tcs), (_, jring, jcs) = _both(name)
    t, j = tcs.to_r1cs(), jcs.to_r1cs()
    assert t.l == j.l == 1
    for mat in ("A", "B", "C"):
        assert _rows(getattr(t, mat)) == _rows(getattr(j, mat)), mat
    pri, aux = assignment(tring, 2)
    assert t.check_relation(tring, pri + aux)
    assert j.check_relation(jring, pri + aux)
    bad = pri + aux[:-1] + [tring.embed_int(7)]
    assert not t.check_relation(tring, bad)


@pytest.mark.parametrize("name", RINGS)
def test_swap_ab_same_on_both(name):
    (_, _, tcs), (_, _, jcs) = _both(name)
    before = [c.a.terms[:] for c in tcs.constraints]
    tcs.swap_AB_if_beneficial()
    jcs.swap_AB_if_beneficial()
    assert [c.a.terms for c in tcs.constraints] == before  # a is the denser side: no swap
    assert [c.a.terms for c in jcs.constraints] == before
    # make b the denser side: both builders swap
    for mod, cs in ((tb, tcs), (jb, jcs)):
        cs.add_constraint(mod.Constraint(
            mod.LinearCombination.single_term(1, 1),
            mod.LinearCombination([(1, 0), (1, 1), (1, 2), (1, 3), (1, 4)]),
            mod.LinearCombination.single_term(1, 0),
        ))
        cs.swap_AB_if_beneficial()
    assert [c.a.terms for c in tcs.constraints] == [c.a.terms for c in jcs.constraints]
    assert tcs.constraints[-1].a.terms == [(1, 0), (1, 1), (1, 2), (1, 3), (1, 4)]


def test_variable_map_same_on_both():
    maps = []
    for mod in (tb, jb):
        vm = mod.VariableMap()
        vm.add("x", 1, 3)
        vm.add("a", 4, 2)
        vm.set_one(0)
        maps.append((vm.total_len, vm.get("x"), vm.get("missing"), vm.get_one(), list(vm.vars())))
    assert maps[0] == maps[1] == (6, (1, 3), None, 0, [("a", (4, 2)), ("x", (1, 3))])


@pytest.mark.parametrize("name", RINGS)
def test_linear_combination_ring_coefficients(name):
    """Coefficients may be host ring elements as well as ints."""
    vals = []
    for mod, ring in ((tb, tget_ring(name)), (jb, get_ring(name))):
        c = ring.embed_int(3)
        lc = mod.LinearCombination().add_term(c, 0).add_terms([(2, 1)])
        assert lc.is_valid(2) and not lc.is_valid(1)
        vals.append(lc.evaluate(ring, [ring.embed_int(5), ring.embed_int(7)]))
    assert vals[0] == vals[1] == tget_ring(name).embed_int(29)
