"""The port's parameter grid (latticefold_torch.paramgen, the bounds.sage
grid) against the JAX package's: generate_grid() gives the same rows for
each ring over the default witness sizes, find_params the same candidate
rows, and ``python -m latticefold_torch.paramgen``'s JSON is the grid.
Tolerance: exact (integers)."""

import json

import pytest

import latticefold_torch.paramgen as tpg
import latticefold_tpu.paramgen as jpg

RINGS = ["goldilocks", "babybear", "stark", "frog"]
# generate_grid's default witness sizes, passed explicitly to the JAX
# function: its default is a generator, spent by its first call
N_RANGE = tuple(1 << e for e in range(9, 16))


@pytest.mark.parametrize("name", RINGS)
def test_generate_grid_matches_jax(name):
    got = tpg.generate_grid(rings=(name,))
    assert got == jpg.generate_grid(rings=(name,), n_range=N_RANGE)
    assert got and all(r["ring"] == name for r in got)
    q = tpg.get_ring(name).q
    for r in got:  # every row covers q (B^L > q) and splits B exactly (b^K == B)
        assert r["B"] ** r["L"] > q and r["b"] ** r["K"] == r["B"]
        assert tpg.ParamRow(**r).dp().B == r["B"]


@pytest.mark.parametrize("name,n,kappa", [("goldilocks", 4096, 9), ("babybear", 512, 6), ("stark", 32768, 17),
                                          ("frog", 1024, 2), ("goldilocks", 32768, 2)])
def test_find_params_matches_jax(name, n, kappa):
    got = tpg.find_params(name, n, kappa)
    want = jpg.find_params(name, n, kappa)
    assert (got is None) == (want is None)
    if got is not None:
        assert [vars(r) for r in got] == [vars(r) for r in want]


def test_main_prints_the_grid(capsys, monkeypatch):
    small = tpg.generate_grid(rings=("frog",), n_range=(512, 1024))
    monkeypatch.setattr(tpg, "generate_grid", lambda: small)
    tpg.main()
    assert json.loads(capsys.readouterr().out) == small


def test_default_range_holds_across_calls():
    first = tpg.generate_grid(rings=("frog",))
    assert tpg.generate_grid(rings=("frog",)) == first
    assert sorted({r["n"] for r in first}) == list(N_RANGE)
