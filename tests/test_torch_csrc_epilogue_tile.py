"""Kernel B's block algorithm on diagonals
(latticefold_torch/csrc/plane_epilogue_diag.cuh, the phases and index maps
that csrc/plane_epilogue_diag_kernel.cu runs) against the plain epilogue,
``plane_commit.epilogue_plain``, on the CPU.

The header compiles as plain C++ too (field_common.cuh), so a small
harness built with g++ runs every block of the kernel's grid, one thread at
a time per phase, in the order the kernel's barriers impose (per slice:
the staging, then the diagonals; then the finish and the fold), with
shared memory filled with garbage first and the output with -1; the lanes
of the nl 1 and 2 instances read their words of P and their corrections
from device memory (``load``), those of nl 8 from the staged tile. Its inputs are real plane
products: an Ajtai matrix and a seeded witness batch at kappa 2 through
the port's ``precompute`` and ``plane_dot_plain``, with ``_K_SLICE`` set to
256 so that n = 200 gives one slice and n = 400 two. Every ring's (nl, e)
runs, at an Nb that leaves the last block's b group ragged, with one and
two b groups a block; BabyBear's 81 warp tasks a b group take the task
loop past the block's 16 warps.

A mutation of any of ``p_row``, ``p_col``, ``diag_jb``, ``diag_pos``,
``task_coords``, ``lane_patch``, ``lane_diag``, ``patch_index``,
``out_index``, ``plane_pitch``, ``tile_index`` or ``piece_coords`` that
misses a word or sends two to one place fails it (a permutation that the writer and the reader of a slot
share, such as swapping two lanes' diagonals, gives the same limbs and
passes, as it should). The copies, the barriers and the launch are the
card's: chip_smoke.py holds the kernel against ``epilogue_plain`` and the
item-per-thread kernel there, at every fold's shape, bench.py's and a
two-slice batch.
``epilogue_plain`` itself is held against the JAX package by
tests/test_torch_plane_commit.py.

Tolerance: exact equality -- every value is an integer mod q."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from latticefold_torch import cuda
from latticefold_torch.commitment import AjtaiScheme
from latticefold_torch.rings import ops
from latticefold_torch.rings import plane_commit as pc
from latticefold_torch.rings.construct import get_ring

SLICE = 256
KAPPA = 2
# ring -> Nb: the last block's b group ragged (a group is 32 / (4 nl) b)
NB = {"babybear": 11, "goldilocks": 6, "frog": 5, "stark": 3}

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "plane_epilogue_diag.cuh"

using namespace epi_diag;

template <class T>
static std::vector<T> load(const char* dir, const char* name, size_t n) {
  std::vector<T> v(n);
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "cannot read %s\n", path);
    std::exit(1);
  }
  fclose(f);
  return v;
}

// every block of the grid, each phase a loop over its warp's or block's threads
template <class F, int E>
static int run(const char* dir, int nsl, int ncomp, int M, int L, int rows, int kappa, int Nb,
               int n, int kslice, int nbb, const u64* consts) {
  typedef Block<F, E> B;
  const auto P = load<int>(dir, "P.bin", (size_t)nsl * ncomp * M * 4 * L);
  const auto sM = load<int>(dir, "sM.bin", (size_t)ncomp * nsl * M);
  const auto red = E > 1 ? load<long long>(dir, "red.bin", (size_t)(E - 1) * E * F::NL)
                         : std::vector<long long>(1);
  std::vector<long long> out((size_t)kappa * Nb * ncomp * E * F::NL, -1);
  const Problem pr{P.data(), sM.data(), red.data(), out.data(), nsl, ncomp, M, L, rows, Nb, n, kslice, nbb};
  const F f = F::from(consts);
  const WideRedc<F::NL> wr = WideRedc<F::NL>::from(consts);
  const int warps = B::warps_per_block(nbb, max_warps(F::NL, E)), nth = WARP * warps;
  const int nb = B::b_per_block(nbb);
  std::vector<u64> smem((B::smem_bytes(nbb) + 7) / 8);
  for (int k = 0; k < kappa; ++k)
    for (int c = 0; c < ncomp; ++c)
      for (int z = 0; z < (Nb + nb - 1) / nb; ++z) {
        for (auto& w : smem) w = 0xA5A5A5A5A5A5A5A5ull;
        const B blk(pr, k, c, z, reinterpret_cast<unsigned char*>(smem.data()));
        for (int t = 0; t < nth; ++t) blk.prologue(t, nth);
        for (int si = 0; si < nsl; ++si) {
          for (int t = 0; t < nth; ++t) blk.stage(si, t, nth);
          for (int t = 0; t < nth; ++t)
            for (int task = t / WARP; task < blk.tasks; task += warps)
              blk.group(si, task, t, B::DIRECT ? blk.load(si, task, t) : typename B::Words{});
        }
        for (int t = 0; t < nth; ++t) blk.finish(t, nth, wr);
        if (E > 1)
          for (int t = 0; t < nth; ++t) blk.fold(f, t, nth);
      }
  fwrite(out.data(), sizeof(long long), out.size(), stdout);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  int nl, e, nsl, ncomp, M, L, rows, kappa, Nb, n, kslice, nbb, nc;
  u64 c[16];
  if (scanf("%d %d %d %d %d %d %d %d %d %d %d %d %d", &nl, &e, &nsl, &ncomp, &M, &L, &rows, &kappa, &Nb, &n,
            &kslice, &nbb, &nc) != 13)
    return 2;
  for (int i = 0; i < nc; ++i) scanf("%llu", &c[i]);
#define LF_RUN(FT, EE) \
  if (nl == FT::NL && e == EE) return run<FT, EE>(argv[1], nsl, ncomp, M, L, rows, kappa, Nb, n, kslice, nbb, c);
  LF_RUN(F32, 9)
  LF_RUN(F64, 3)
  LF_RUN(F64, 4)
  LF_RUN(F256, 1)
  return 3;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the epilogue header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("epilogue_tile")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    return str(exe)


def plane_products(ring, n, Nb, seed, kappa=KAPPA, kslice=SLICE):
    """(P, sM, rows) of a seeded witness batch: the slices' plane products
    as kernel A gives them."""
    scheme = AjtaiScheme(ring, kappa, n, seed=seed, device="cpu")
    pre = scheme._fused_planes
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=(ring.ncomp, n, ring.e, Nb, ring.nl), dtype=np.uint64)
    limbs[..., -1] %= np.uint64(ring.q >> (32 * (ring.nl - 1)))  # canonical: below q
    w2d = torch.from_numpy(limbs.astype(np.int64)).reshape(ring.ncomp, n, -1)
    del limbs
    P = torch.stack([pc.plane_dot_plain(pre.lhs_i8[:, :, k0 : k0 + kslice], w2d[:, k0 : k0 + kslice])
                     for k0 in range(0, n, kslice)])
    return P, pre.sM, pre.rows


def check_blocks(harness, tmp_path, ring, P, sM, rows, n, Nb, kappa, kslice):
    """Every block of kernel B's grid, at one and two b groups a block,
    against the plain epilogue on (P, sM)."""
    nsl, c, mpad, four_l = P.shape
    assert nsl == -(-n // kslice)
    want = pc.epilogue_plain(ring, P, sM, rows, n, Nb)
    P.numpy().astype(np.int32).tofile(tmp_path / "P.bin")
    sM.numpy().astype(np.int32).tofile(tmp_path / "sM.bin")
    red = ops.red_rows(ring, torch.device("cpu"))
    if red is not None:
        red.numpy().astype(np.int64).tofile(tmp_path / "red.bin")
    words = list(cuda.field_constants(ring.q, ring.nl))
    for nbb in (1, 2):
        head = [ring.nl, ring.e, nsl, c, mpad, four_l // 4, rows, kappa, Nb, n, kslice, nbb, len(words)]
        run = subprocess.run([harness, str(tmp_path)], input=(" ".join(map(str, head + words)) + "\n").encode(),
                             capture_output=True, check=True)
        got = np.frombuffer(run.stdout, dtype=np.int64).reshape(tuple(want.shape))
        assert np.array_equal(got, want.numpy()), (ring.name, n, nbb, int((got != want.numpy()).sum()))


@pytest.mark.parametrize("n", [200, 400], ids=["one_slice", "two_slices"])
@pytest.mark.parametrize("name", list(NB))
def test_diagonal_blocks_match_plain_epilogue(harness, tmp_path, monkeypatch, name, n):
    monkeypatch.setattr(pc, "_K_SLICE", SLICE)
    ring = get_ring(name)
    P, sM, rows = plane_products(ring, n, NB[name], seed=3 + n)
    check_blocks(harness, tmp_path, ring, P, sM, rows, n, NB[name], KAPPA, SLICE)


def test_diagonal_blocks_match_plain_epilogue_five_slices(harness, tmp_path):
    """Five slices at the shape of the big-m Goldilocks fold's batch commits
    (m 2^18: kappa 9, n 163840 = 5 x 2^15, Nb = K - 1 = 14, the real
    ``_K_SLICE``): kernel B with nsl 5, which the card runs only there."""
    ring = get_ring("goldilocks")
    n, Nb, kappa = 5 * pc._K_SLICE, 14, 9
    P, sM, rows = plane_products(ring, n, Nb, seed=11, kappa=kappa, kslice=pc._K_SLICE)
    check_blocks(harness, tmp_path, ring, P, sM, rows, n, Nb, kappa, pc._K_SLICE)
