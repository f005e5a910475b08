"""The port's LatticeFold+ (``latticefold_torch.plus``) at the reference
sweep's sizes: the streamed tensors and the shapes past k 2.

The prover takes its large tensors a chunk at a time (the sumcheck's
folds, the MLE openings, the sparse products, the h vectors, the set
check's bucket sums, the monomial columns' commits) and writes the cm and
set-check stacks in place. Modular sums are exact, so none of this may
change a byte: tier-1 forces every chunk and group small and holds the
port's n 2^13 proof to the JAX prover's digest (``JAX_PLUS_E2E_SHA256``),
and holds each streamed function against its unstreamed formula on seeded
inputs (numpy). At k 3 or 5 a power-of-two n is not m k: ``ComR1CS.new``
pads f with zero rows to the scheme's width. The slow test proves (n 2^15,
k 3, kappa 1, L 2) with the JAX prover on the CPU (eagerly, as
tests/test_plus.py runs it) and with the port: the same bytes, whose
SHA-256 ``chip_smoke.py`` holds the card's proof to (``PLUS_K3_SHA256``).
Tolerance: exact equality -- every value is an integer mod q."""

import hashlib
import time

import numpy as np
import pytest
import torch

from latticefold_torch import convert
from latticefold_torch import modops as tmo
from latticefold_torch import serialization as tser
from latticefold_torch.arith import sparse as tsparse
from latticefold_torch.arith.sparse import SparseMatrix as TSparseMatrix
from latticefold_torch.plus import PlusParameters as TPlusParameters
from latticefold_torch.plus import PlusProver as TPlusProver
from latticefold_torch.plus import PlusTranscript as TPlusTranscript
from latticefold_torch.plus import PlusVerifier as TPlusVerifier
from latticefold_torch.plus import cm as tcm
from latticefold_torch.plus import coeffring as tcr
from latticefold_torch.plus import mleops as tmleops
from latticefold_torch.plus import rgchk as trgchk
from latticefold_torch.plus import setchk as tsetchk
from latticefold_torch.plus import sumcheck as tpsc
from latticefold_torch.plus.r1cs import gadget_decompose_vec as tgadget_decompose_vec
from latticefold_torch.rings import ops as tops
from test_torch_plus import JAX_PLUS_E2E_SHA256, RG_N, TRING, port_plus_setup, rand_limbs

CPU = "cpu"

# SHA-256 of the JAX prover's serialize_plus_proof bytes at (n 2^15, k 3,
# kappa 1, L 2): _plus_setup's instance (identity R1CS of m = n // 3, z all
# ones, Ajtai seed 7, B = estimate_bound + 1) with f padded to n, proved as
# PlusProver.prove([c, c]) (re-derived by test_plus_k3_matches_jax_live)
PLUS_K3_SHA256 = "20893643c7db97542263d3f81eb3a360326860e15cf51205885aa62a4d74182a"
K3 = (1 << 15, 3, 1, 2)  # n, k, kappa, L


def _ring_tables(shape, seed):
    return convert.tensor(rand_limbs(TRING, tuple(shape) + (TRING.ncomp, TRING.e), np.random.default_rng(seed)), CPU)


def _scalar_tables(shape, seed):
    return convert.tensor(rand_limbs(TRING, shape, np.random.default_rng(seed)), CPU)


def _limbs(t):
    return convert.to_numpy(t)


# ---------------------------------------------------------------------------
# each streamed function against its unstreamed formula
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_place", [False, True], ids=["new", "in_place"])
def test_fold_chunked(monkeypatch, in_place):
    """_fold a few pairs at a time, into a new tensor or into the first half
    of its input, equals a0 + c (a1 - a0) over the whole table."""
    fq = TRING.fq
    mles = _ring_tables((3, 64), 1)
    c = tmleops.scalar_dev(TRING, 123456789, CPU)
    a0, a1 = mles[:, 0::2], mles[:, 1::2]
    want = tmo.add(fq, a0, tmo.mont_mul(fq, tmo.sub(fq, a1, a0), c))
    monkeypatch.setattr(tpsc, "_CHUNK_VALUES", 3 * 16 * 5)  # 5 pairs a chunk
    src = mles.clone()
    got = tpsc._fold(TRING, src, c, src[:, :32] if in_place else None)
    assert np.array_equal(_limbs(got), _limbs(want))
    if not in_place:
        assert np.array_equal(_limbs(src), _limbs(mles))


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "ring"])
def test_sumcheck_chunked(monkeypatch, scalar):
    """prove_host with one-pair chunks gives the proof, challenges and
    final values of one chunk, and leaves the caller's tables intact."""
    vdims = () if scalar else (TRING.ncomp, TRING.e)
    fq = TRING.fq

    def fn(v, c):
        if scalar:
            return tmo.mont_mul(fq, tmo.mont_mul(fq, v[0], v[1]), v[2])
        return tmo.add(fq, tops.ext_mul(TRING, v[0], v[1]), v[2])

    comb = tpsc.CombFn(fn, scalar=scalar)
    mles = convert.tensor(rand_limbs(TRING, (3, 32) + vdims, np.random.default_rng(7)), CPU)
    want = tpsc.prove_host(TRING, TPlusTranscript(TRING), mles.clone(), 5, 2 if not scalar else 3, comb)
    monkeypatch.setattr(tpsc, "_CHUNK_VALUES", 1)
    src = mles.clone()
    got = tpsc.prove_host(TRING, TPlusTranscript(TRING), src, 5, 2 if not scalar else 3, comb)
    assert got[0].round_evals == want[0].round_evals and got[1] == want[1]
    assert np.array_equal(_limbs(got[2]), _limbs(want[2]))
    assert np.array_equal(_limbs(src), _limbs(mles))


@pytest.mark.parametrize("ring_mles", [True, False], ids=["ring", "scalar"])
def test_eval_chunked(monkeypatch, ring_mles):
    """The MLE openings a few rows at a time equal the one-chunk sum."""
    eq = _scalar_tables((40,), 3)
    mles = _ring_tables((4, 40), 4) if ring_mles else _scalar_tables((4, 40), 4)
    fn = tmleops.eval_ring_mles_scalar if ring_mles else tmleops.eval_scalar_mles
    want = fn(TRING, mles, eq)
    monkeypatch.setattr(tmleops, "_EVAL_VALUES", 7)
    assert np.array_equal(_limbs(fn(TRING, mles, eq)), _limbs(want))


def _mat_rows(rng, nrows, ncols, ring_coeffs):
    rows = []
    for _ in range(nrows):
        row = []
        for j in rng.choice(ncols, size=int(rng.integers(0, 4)), replace=False):
            if ring_coeffs:
                c = TRING.crt_host([int(v) for v in rng.integers(0, TRING.q, size=TRING.d, dtype=np.uint64)])
            else:
                c = int(rng.integers(0, TRING.q, dtype=np.uint64))
            row.append((c, int(j)))
        rows.append(row)
    return rows


@pytest.mark.parametrize("ring_coeffs", [False, True], ids=["scalar", "ring"])
def test_mat_vec_batched_chunked(monkeypatch, ring_coeffs):
    """mat_vec_batched a few rows at a time, into a new tensor and into a
    given one, equals the host product row by row."""
    rng = np.random.default_rng(11)
    M = TSparseMatrix(TRING, 24, 20, _mat_rows(rng, 24, 20, ring_coeffs))
    z = _ring_tables((2, 20), 12)
    monkeypatch.setattr(tsparse, "_MATVEC_VALUES", 50)
    got = M.mat_vec_batched(z)
    out = torch.full_like(got, -1)
    assert M.mat_vec_batched(z, out=out) is out
    for b in range(2):
        zh = list(tops.to_host(TRING, z[b]))
        want = tops.to_device(TRING, M.mat_vec_host(zh), CPU)
        assert np.array_equal(_limbs(got[b]), _limbs(want))
        assert np.array_equal(_limbs(out[b]), _limbs(want))


@pytest.mark.parametrize("ndim", [1, 2])
def test_bucket_chunked(monkeypatch, ndim):
    """_bucket_dev a few rows at a time (exponent -1 skipped) equals the
    host bucket sums."""
    rng = np.random.default_rng(20 + ndim)
    shape = (30,) if ndim == 1 else (30, 5)
    idx = rng.integers(-1, TRING.d, size=shape)
    w = _scalar_tables((32,), 21 + ndim)
    w_host = tmleops.host_ints(TRING, w)
    want = np.zeros(shape[1:] + (TRING.d,), dtype=object)
    for x in range(30):
        for pos in np.ndindex(*shape[1:]):
            e = idx[(x,) + pos]
            if e >= 0:
                want[pos + (e,)] = (want[pos + (e,)] + w_host[x]) % TRING.q
    monkeypatch.setattr(tsetchk, "_BUCKET_VALUES", 100)
    assert np.array_equal(tsetchk._bucket_dev(TRING, torch.as_tensor(idx), w), want)


def _cm_stack_reference(rg, r, h, t_pair, M):
    """The unstreamed stack: a list of tables, then torch.stack."""
    mono = tcr.monomial_table(TRING, torch.device(CPU))
    eq_scalar = tmleops.build_eq_scalar(TRING, tmleops.scalars_dev(TRING, r, CPU))
    tables = [trgchk.scalar_to_ring_table(TRING, eq_scalar)]
    for li, inst in enumerate(rg.instances):
        group = [trgchk.const_ring_batch(TRING, inst.tau), mono[inst.m_tau_idx], inst.f_ntt, h[li]]
        tables.extend(group)
        for Mi in M:
            tables.extend(Mi.mat_vec_batched(torch.stack(group)))
    tables.extend(t_pair)
    return torch.stack(tables)


def test_cm_stack_in_place(monkeypatch):
    """_build_cm_mles, written table by table into one tensor (h a few rows
    at a time), equals torch.stack of the same tables at a tiny n (16
    rows, L 2, three seeded sparse matrices)."""
    n, L, k = 16, 2, 2
    rng = np.random.default_rng(30)
    insts = []
    for li in range(L):
        tau = torch.as_tensor(rng.integers(-4, 5, size=n))
        insts.append(trgchk.RgInstance(
            ring=TRING, f_ntt=_ring_tables((n,), 31 + li), f_coeff_mont=None,
            D_idx=torch.as_tensor(rng.integers(0, TRING.d, size=(k, n, TRING.d))), tau=tau,
            m_tau_idx=tau % TRING.d, comM_f=None, fcoms=None))
    rg = trgchk.Rg(nvars=4, instances=insts, dparams=trgchk.DecompParameters(b=8, k=k, l=22))
    M = [TSparseMatrix(TRING, n, n, _mat_rows(rng, n, n, False)) for _ in range(3)]
    r = [int(v) for v in rng.integers(0, TRING.q, size=4, dtype=np.uint64)]
    t_pair = [_ring_tables((n,), 40), _ring_tables((n,), 41)]
    s_prime = _ring_tables((k, TRING.d), 42)
    h = tcm._h_vectors(TRING, rg, s_prime)
    monkeypatch.setattr(tcm, "_H_ROWS", 3)
    h_chunked = tcm._h_vectors(TRING, rg, s_prime)
    assert all(np.array_equal(_limbs(a), _limbs(b)) for a, b in zip(h, h_chunked))
    want = _cm_stack_reference(rg, r, h, t_pair, M)
    got = tcm._build_cm_mles(TRING, rg, r, h_chunked, t_pair, M)
    assert got.shape == want.shape == (1 + L * 16 + 2, n, TRING.ncomp, TRING.e, TRING.nl)
    assert np.array_equal(_limbs(got), _limbs(want))


def test_comr1cs_pads_to_scheme_width():
    """k 3 at n 64: m k = 63 rows of gadget digits, then one zero row; the
    commitment is the padded witness's. The linearization and the set
    check's openings take the 63-column matrices (the verifier accepts)."""
    from latticefold_torch.plus import linearize, verify_linearization

    scheme, c, params, B = port_plus_setup(64, 3)
    f = tgadget_decompose_vec(TRING, c.x.z, B, 3)
    assert f.shape[0] == 63 and c.f.shape[0] == 64
    assert np.array_equal(_limbs(c.f[:63]), _limbs(f)) and not c.f[63].any()
    assert c.x.cm_f == [TRING.icrt_host(x) for x in tops.to_host(TRING, scheme.commit_device(c.f))]
    assert all(Mi.ncols == 63 and Mi.nrows == 64 for Mi in c.x.matrices)
    _, proof = linearize(c, TPlusTranscript(TRING))
    verify_linearization(TRING, proof, TPlusTranscript(TRING))


# ---------------------------------------------------------------------------
# the whole prover, streamed
# ---------------------------------------------------------------------------


def test_streamed_prove_matches_jax_digest(monkeypatch):
    """Every chunk and group of the prover forced small, so that each
    streamed tensor of the n 2^13 prove is taken in 3 to 5 pieces (the
    first rounds' folds and combs, the openings, the sparse products, the
    bucket sums, h, the monomial columns' commit 5 columns a group): the
    port's n 2^13, k 1 proof still hashes to the JAX prover's
    digest, and the port's verifier accepts it."""
    monkeypatch.setattr(tpsc, "_CHUNK_VALUES", 1 << 19)
    monkeypatch.setattr(tmleops, "_EVAL_VALUES", 1 << 19)
    monkeypatch.setattr(tsparse, "_MATVEC_VALUES", 1 << 17)
    monkeypatch.setattr(tsetchk, "_BUCKET_VALUES", 1 << 19)
    monkeypatch.setattr(tcm, "_H_ROWS", 3000)
    monkeypatch.setattr(trgchk, "_MF_GROUP_BYTES", RG_N * TRING.d * TRING.nl * 8 * 5)
    assert trgchk.mf_group_cols(TRING, RG_N) == 5
    scheme, c, params, B = port_plus_setup(RG_N, 1)
    pparams = TPlusParameters(lin=params, B=B)
    proof = TPlusProver(scheme=scheme, M=c.x.matrices, transcript=TPlusTranscript(TRING), params=pparams).prove([c])
    blob = tser.serialize_plus_proof(TRING, proof)
    assert hashlib.sha256(blob).hexdigest() == JAX_PLUS_E2E_SHA256
    assert TPlusVerifier(ring=TRING, M=c.x.matrices, transcript=TPlusTranscript(TRING), params=pparams).verify(proof)


def test_chip_smoke_holds_the_k3_digest():
    """chip_smoke.py holds the card's (n 2^15, k 3, kappa 1, L 2) proof to
    this file's PLUS_K3_SHA256, at this file's shape."""
    import chip_smoke

    assert chip_smoke.PLUS_K3_SHA256 == PLUS_K3_SHA256
    assert chip_smoke.PLUS_K3 == K3


# ---------------------------------------------------------------------------
# the JAX prover at k 3, L 2
# ---------------------------------------------------------------------------


def _jax_k3_instance():
    """_plus_setup's instance at K3 in the JAX package. Its ComR1CS.new
    takes only n = m k, so the instance is built from its parts: the JAX
    gadget digits padded with zero rows to n, committed with the JAX
    scheme, the matrices widened to n columns (their columns past m k are
    empty, so no product changes)."""
    import jax.numpy as jnp

    from latticefold_tpu.commitment import AjtaiScheme
    from latticefold_tpu.plus import ComR1CS, estimate_bound
    from latticefold_tpu.plus.r1cs import ComR1CSX, gadget_decompose_vec, r1cs_decomposed_square
    from latticefold_tpu.rings import ops as jops
    from test_plus import RING, identity_sparse, ring_vec_from_coeff_rows

    n, k, kappa, _ = K3
    m = n // k
    B = estimate_bound(RING.d * 128, 3, RING.d, k) + 1
    mats = r1cs_decomposed_square(RING, *(identity_sparse(m) for _ in range(3)), n, B, k)
    for Mi in mats:
        Mi.ncols = n
    scheme = AjtaiScheme(RING, kappa, n, seed=7)
    z = ring_vec_from_coeff_rows([[1] + [0] * (RING.d - 1) for _ in range(m)])
    f = gadget_decompose_vec(RING, z, B, k)
    f = jnp.concatenate([f, jnp.zeros((n - f.shape[0],) + f.shape[1:], f.dtype)])
    cm_f = [RING.icrt_host(tuple(x)) for x in jops.to_host(RING, scheme.commit_device(f))]
    return RING, scheme, ComR1CS(x=ComR1CSX(matrices=list(mats), z=z, cm_f=cm_f, l_in=1), f=f), B


@pytest.mark.slow
def test_plus_k3_matches_jax_live():
    """The JAX prover at (n 2^15, k 3, kappa 1, L 2 in one round) on the
    CPU: its bytes hash to PLUS_K3_SHA256, the port's CPU proof of its own
    setup (``ComR1CS.new``'s padding, matrices of m k columns) gives the
    same bytes, and the port's verifier accepts it."""
    import jax

    import latticefold_tpu.serialization as jser
    from latticefold_tpu.plus import LinParameters, PlusParameters, PlusProver, PlusTranscript
    from test_plus import dparams

    n, k, kappa, L = K3
    scheme, c, params, B = port_plus_setup(n, k, kappa)
    pparams = TPlusParameters(lin=params, B=B)
    proof = TPlusProver(scheme=scheme, M=c.x.matrices, transcript=TPlusTranscript(TRING), params=pparams).prove([c] * L)
    blob = tser.serialize_plus_proof(TRING, proof)
    assert TPlusVerifier(ring=TRING, M=c.x.matrices, transcript=TPlusTranscript(TRING), params=pparams).verify(proof)

    ring, jscheme, jc, jB = _jax_k3_instance()
    assert jB == B and jc.x.cm_f == c.x.cm_f
    jparams = PlusParameters(lin=LinParameters(kappa=kappa, decomp=dparams(k=k)), B=jB)
    t0 = time.perf_counter()
    with jax.disable_jit():
        jproof = PlusProver(scheme=jscheme, M=jc.x.matrices, transcript=PlusTranscript(ring), params=jparams).prove(
            [jc] * L)
    jblob = jser.serialize_plus_proof(ring, jproof)
    print(f"JAX prove at {K3}: {time.perf_counter() - t0:.1f} s, sha256 {hashlib.sha256(jblob).hexdigest()}")
    assert blob == jblob
    assert hashlib.sha256(jblob).hexdigest() == PLUS_K3_SHA256
