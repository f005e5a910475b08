"""The fold's batch commit on the byte-plane route: latticefold_torch's
decomposition commits its K - 1 digit witnesses as one component-major
batch through ``AjtaiScheme.commit_batch_fused`` (kernels A and B of
rings/plane_commit.py; on the CPU their plain versions), and those limbs
equal the JAX package's ``scheme.commit_batch``.

Shapes: the small fixture of tests/test_torch_nifs.py (kappa 4, seed 7,
Goldilocks), and a ragged batch (n = 100, not a multiple of 32; L =
e Nb nl = 18 words, not a multiple of 16). The proof bytes of the whole
fold against the JAX prover stay in tests/test_torch_nifs.py.

Tolerance: exact equality (0) of limbs and commitments -- every value is an
integer mod q."""

import numpy as np
import pytest
import torch

import latticefold_torch.nifs as tnifs
import latticefold_torch.nifs.linearization as tlinearization
from latticefold_torch import convert
from latticefold_torch import params as tparams
from latticefold_torch.arith.ccs import CCCS as TCCCS
from latticefold_torch.arith.ccs import CCS as TCCS
from latticefold_torch.arith.ccs import get_test_r1cs as tget_test_r1cs
from latticefold_torch.arith.ccs import get_test_z_split as tget_test_z_split
from latticefold_torch.arith.witness import Witness as TWitness
from latticefold_torch.commitment import AjtaiScheme as TScheme
from latticefold_torch.nifs import decomposition as tdecomposition
from latticefold_torch.rings import ops as trops
from latticefold_torch.rings.construct import get_ring as tget_ring
from latticefold_torch.transcript import Transcript as TTranscript
from latticefold_tpu.commitment import AjtaiScheme
from latticefold_tpu.rings.construct import get_ring

KAPPA = 4


def _fixture():
    """The port's small Goldilocks fixture on the CPU: scheme, witness,
    instance, accumulator."""
    dp = tparams.DP_GOLDILOCKS
    ring = tget_ring("goldilocks")
    ccs = TCCS.from_r1cs_padded(ring, tget_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = tget_test_z_split(ring, 3)
    scheme = TScheme(ring, KAPPA, len(w_host) * dp.L, seed=7, device="cpu")
    wit = TWitness.from_w_ccs(ring, dp, trops.to_device(ring, w_host, "cpu"), n_pad=ccs.m)
    cm_i = TCCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = tlinearization.prove(cm_i, wit, TTranscript(ring), ccs)
    return dp, ring, ccs, scheme, wit, cm_i, acc


def test_decomposition_batch_fused_matches_jax_commit_batch():
    """The decomposition's component-major digit batch through
    ``commit_batch_fused`` equals JAX ``commit_batch`` on the same digits
    (n-major, as the JAX decomposition stacks them)."""
    dp, ring, ccs, scheme, wit, _, _ = _fixture()
    wit_s = tdecomposition.decompose_witness(ring, dp, wit, ccs.m)
    batch = tdecomposition.digit_batch(ring, [w.f for w in wit_s[1:]])
    assert tuple(batch.shape) == (ring.ncomp, scheme.n, ring.e, dp.K - 1, ring.nl)
    got = convert.to_numpy(scheme.commit_batch_fused(batch))
    jscheme = AjtaiScheme(get_ring("goldilocks"), KAPPA, scheme.n, seed=7)
    assert np.array_equal(np.asarray(jscheme.matrix), convert.to_numpy(scheme.matrix))
    nmajor = np.stack([convert.to_numpy(w.f) for w in wit_s[1:]], axis=1)  # [n, K-1, ncomp, e, nl]
    want = np.asarray(jscheme.commit_batch(nmajor))
    assert got.shape == want.shape and np.array_equal(got, want)


def test_ragged_batch_fused_matches_jax_commit_batch():
    """n = 100 and L = 18 words: neither a multiple of the kernels' tiles."""
    ring = get_ring("goldilocks")
    n, nb = 100, 3
    assert n % 32 and (ring.e * nb * ring.nl) % 16
    rng = np.random.default_rng(29)
    limbs = rng.integers(0, 1 << 32, size=(ring.ncomp, n, ring.e, nb, ring.nl), dtype=np.uint64).astype(np.uint32)
    limbs[..., -1] >>= 1  # below q
    jscheme = AjtaiScheme(ring, 2, n, seed=13)
    want = np.asarray(jscheme.commit_batch(np.ascontiguousarray(limbs.transpose(1, 3, 0, 2, 4))))
    tscheme = convert.ajtai_scheme(tget_ring("goldilocks"), np.asarray(jscheme.matrix), "cpu")
    got = convert.to_numpy(tscheme.commit_batch_fused(convert.tensor(limbs, "cpu")))
    assert np.array_equal(got, want)


def test_fold_commits_only_through_the_byte_plane_route(monkeypatch):
    """With ``commit_batch`` (the commit kernel's path) raising, the fold
    still proves: its two batch commits go through ``commit_batch_fused``;
    the port's verifier accepts the proof and w0 opens the folded
    commitment."""
    dp, ring, ccs, scheme, wit, cm_i, acc = _fixture()
    calls = []
    fused = TScheme.commit_batch_fused

    def spy(self, fcm):
        calls.append(tuple(fcm.shape))
        return fused(self, fcm)

    def refuse(self, f):
        raise AssertionError("the fold called commit_batch")

    with monkeypatch.context() as m:
        m.setattr(TScheme, "commit_batch", refuse)
        m.setattr(TScheme, "commit_batch_fused", spy)
        folded, w0, proof = tnifs.prove(acc, wit, cm_i, wit, TTranscript(ring), ccs, scheme, dp)
    assert calls == [(ring.ncomp, scheme.n, ring.e, dp.K - 1, ring.nl)] * 2
    folded_v = tnifs.verify(acc, cm_i, proof, TTranscript(ring), ccs, dp)
    assert folded_v.cm == folded.cm
    assert w0.commit(scheme) == folded.cm


def _babybear_batch(n, nb, seed):
    """A contiguous BabyBear batch [8, n, 9, nb, 1] of values below q: rows
    of 9 nb int64 words, 16-byte aligned only for even nb."""
    ring = tget_ring("babybear")
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, ring.q, size=(ring.ncomp, n, ring.e, nb, ring.nl), dtype=np.int64)
    return ring, torch.from_numpy(limbs)


def test_aligned_batch_copies_only_misaligned_rows():
    """``plane_commit.aligned_batch``: an odd-Nb contiguous batch comes back
    as a copy with equal values and 16-byte row strides; an aligned batch
    (even Nb, or the copy itself) comes back as the same tensor."""
    from latticefold_torch.rings import plane_commit as tpc

    ring, fcm = _babybear_batch(5, 7, 41)
    c, n, e, nb, nl = fcm.shape
    got = tpc.aligned_batch(ring, fcm)
    assert got.data_ptr() != fcm.data_ptr() and torch.equal(got, fcm)
    rows = got.view(c, n, e * nb * nl)
    assert rows.stride(-1) == 1 and rows.data_ptr() % 16 == 0
    assert rows.stride(0) * 8 % 16 == 0 and rows.stride(1) * 8 % 16 == 0
    assert tpc.aligned_batch(ring, got).data_ptr() == got.data_ptr()
    _, even = _babybear_batch(5, 2, 42)
    assert tpc.aligned_batch(ring, even).data_ptr() == even.data_ptr()


def test_odd_nb_babybear_batch_fused_matches_commit_batch_cm():
    """A contiguous BabyBear batch with Nb = 7 (63 words a row) commits
    through ``commit_batch_fused`` to the limbs ``commit_batch_cm`` gives."""
    ring, fcm = _babybear_batch(48, 7, 43)
    scheme = TScheme(ring, 2, 48, seed=5, device="cpu")
    assert torch.equal(scheme.commit_batch_fused(fcm), scheme.commit_batch_cm(fcm))


@pytest.mark.parametrize("mpad,groups", [
    (32, (1, 64)), (96, (1, 128)), (128, (1, 128)), (224, (1, 224)),
    (256, (2, 128)), (416, (2, 224)), (576, (3, 192)), (800, (4, 224)),
])
def test_sm90_row_groups(mpad, groups):
    """The Hopper dot's row groups: the fewest groups of at most 224 rows
    that cover Mpad, each of an instantiated width."""
    from latticefold_torch.rings import plane_commit as tpc

    assert tpc.sm90_groups(mpad) == groups
    g, n = groups
    assert g * n >= mpad > (g - 1) * 224 and n in tpc._SM90_WIDTHS


@pytest.mark.parametrize("tiles,ks,want", [(24, 1 << 15, 5), (96, 1 << 15, 1), (256, 1 << 15, 1),
                                           (16, 1 << 14, 8), (1, 100, 1)])
def test_split_k_sm90_one_wave(tiles, ks, want):
    """K splits of the Hopper dot: blocks fit one wave of a 132-SM card,
    no split shorter than _SM90_MIN_SPLIT_K unless K is."""
    from latticefold_torch.rings import plane_commit as tpc

    got = tpc.split_k_sm90(tiles, ks, 132)
    assert got == want
    assert tiles * got <= max(132, tiles)
    assert got == 1 or ks // got >= tpc._SM90_MIN_SPLIT_K
