"""Kernel C's Hopper GEMM (latticefold_torch/csrc/int_gemm_sm90.cuh on
plane_frags_sm90.cuh) against ``int_gemm_plain``, on the CPU.

The headers compile as plain C++ too, so a small harness built with g++
runs every block of the kernel's grid a thread at a time: B's N-contiguous
rows staged as the stage's TMA box of 32-bit words writes them (128-byte
swizzled rows, ``w_index_sw``; zero words
past B's last word and rows past the split's end; B's storage is padded to
16-byte rows with garbage bytes past N), each consumer's wgmma A-operand
registers built from them by ``plane_frags<FRAG_BYTES, true>`` (B's columns
permuted in each warp's 16), the product with A's rows in the 8-bit wgmma
register layout (signed or unsigned bytes), the K splits written to the
workspace and reduced by the last split to arrive, in three seeded random
arrival orders, and the accumulators stored to C through ``gemm_col``
(the permutation undone) and ``acc_row``, masked at M and N. Each order's C
must equal ``int_gemm_plain``, and every tile counter must read 0 after
each. The plan (row-group width, K splits) is the wrapper's own
(``plane_probes.gemm_groups``, ``gemm_split_k`` at 132 SMs). The TMA copies,
the wgmma and the atomics are the card's work: chip_smoke.py holds the
kernel itself against ``int_gemm_plain``.

Tolerance: exact equality -- every value is an integer."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from latticefold_torch import cuda
from latticefold_torch.rings import plane_probes as pp

SMS = 132  # an H100's SMs: the plan the wrapper makes there

HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <random>
#include <vector>
#include "int_gemm_sm90.cuh"

using namespace sm90;

int M, N, K, U8, ksplit, seed, ldb;
std::vector<unsigned char> A, B;  // A [M][K]; B [K][ldb], ldb = N rounded up to 16

int val(unsigned char x) { return U8 ? (int)x : (int)(signed char)x; }

template <int R>
int run() {
  const int n = 2 * R;
  const int kper = split_k_per(K, ksplit);
  const int words = (N + 3) / 4, ctiles = (words + 31) / 32, rgroups = (M + n - 1) / n;
  const int tiles = rgroups * ctiles;
  std::vector<int> ws((size_t)tiles * ksplit * R * GEMM_THREADS, 0x5A5A5A5A), counters(tiles, 0);
  // per (tile, split, consumer thread) the accumulator registers after the main loop
  std::vector<int> acc((size_t)tiles * ksplit * GEMM_THREADS * R, 0);
  std::vector<u32> stage(KB * 32);
  static int X[2][64][KB];
  for (int rg = 0; rg < rgroups; ++rg)
    for (int ct = 0; ct < ctiles; ++ct)
      for (int sp = 0; sp < ksplit; ++sp) {
        const int tile = gemm_tile(rg, ct, ctiles);
        const int kbeg = sp * kper, kend = std::min(K, kbeg + kper);
        for (int k0 = kbeg; k0 < kend; k0 += KB) {
          // the stage's word tile: rows past the split's end and words past B's last are 0
          for (int r = 0; r < KB; ++r)
            for (int o = 0; o < 32; ++o) {
              const int k = k0 + r, word = 32 * ct + o;
              u32 v = 0;
              if (k < kend && word < words)
                for (int i = 0; i < 4; ++i) v |= (u32)B[(size_t)k * ldb + 4 * word + i] << (8 * i);
              stage[w_index_sw(r, o)] = v;
            }
          for (int wsub = 0; wsub < 2; ++wsub)
            for (int w = 0; w < 4; ++w)
              for (int lane = 0; lane < 32; ++lane) {
                const int col = frag_col(wsub, w, lane);
                for (int ks = 0; ks < KB / 32; ++ks) {
                  u32 a[4];
                  plane_frags<FRAG_BYTES, true>(a, stage.data(), 32, 1, col, ks, lane);
                  for (int r = 0; r < 4; ++r)
                    for (int i = 0; i < 4; ++i)
                      X[wsub][16 * w + (lane >> 2) + 8 * (r & 1)][32 * ks + frag_k(lane, r, i)] =
                          val((a[r] >> (8 * i)) & 0xFF);
                }
              }
          // D += X^T-rows x A^T: A's row group of n rows, zero past M and past the split
          for (int t = 0; t < GEMM_THREADS; ++t) {
            const int wsub = t >> 7, w = (t >> 5) & 3, lane = t & 31;
            int* d = &acc[(((size_t)tile * ksplit + sp) * GEMM_THREADS + t) * R];
            for (int j = 0; j < R; ++j) {
              const int m = 16 * w + (lane >> 2) + 8 * ((j >> 1) & 1);
              const int row = rg * n + acc_row(lane, j);
              if (row >= M) continue;
              long long s = 0;
              for (int r = 0; r < KB && k0 + r < kend; ++r) s += (long long)X[wsub][m][r] * val(A[(size_t)row * K + k0 + r]);
              d[j] += (int)s;
            }
          }
        }
      }
  // the splits arrive in seeded random orders; each order stores C
  std::mt19937 rng(seed);
  int bad_counters = 0;
  for (int order = 0; order < 3; ++order) {
    std::vector<long long> C((size_t)M * N, -(1ll << 40));
    for (int rg = 0; rg < rgroups; ++rg)
      for (int ct = 0; ct < ctiles; ++ct) {
        const int tile = gemm_tile(rg, ct, ctiles);
        std::vector<int> arrive(ksplit);
        for (int sp = 0; sp < ksplit; ++sp) arrive[sp] = sp;
        std::shuffle(arrive.begin(), arrive.end(), rng);
        for (int sp : arrive) {
          // every consumer thread writes its partial, then one ticket per block
          for (int t = 0; t < GEMM_THREADS; ++t) {
            int r[R];
            for (int j = 0; j < R; ++j) r[j] = acc[(((size_t)tile * ksplit + sp) * GEMM_THREADS + t) * R + j];
            ws_store(&ws[ws_slot(tile, sp, ksplit, R)], r, t);
          }
          bool last = true;
          if (ksplit > 1) {
            last = last_split(counters[tile]++, ksplit);
            if (last) counters[tile] = 0;
          }
          if (!last) continue;
          for (int t = 0; t < GEMM_THREADS; ++t) {
            int r[R];
            const int* d = &acc[(((size_t)tile * ksplit + sp) * GEMM_THREADS + t) * R];
            for (int j = 0; j < R; ++j) r[j] = d[j];
            if (ksplit > 1) fixup_sum(r, ws.data(), tile, sp, ksplit, t, [](int (&v)[4], const int* p) { for (int i = 0; i < 4; ++i) v[i] = p[i]; });
            const int wsub = t >> 7, w = (t >> 5) & 3, lane = t & 31;
            for (int j = 0; j < R; ++j) {
              const int row = rg * n + acc_row(lane, j), c = 4 * 32 * ct + gemm_col(wsub, w, lane, j);
              if (row < M && c < N) C[(size_t)row * N + c] = r[j];
            }
          }
        }
      }
    for (int v : counters) bad_counters += v != 0;
    printf("%d %d\n", kper, ksplit);
    for (long long v : C) printf("%lld ", v);
    printf("\n");
  }
  printf("%d\n", bad_counters);
  return 0;
}

int main() {
  int n;
  if (scanf("%d %d %d %d %d %d %d", &M, &N, &K, &U8, &n, &ksplit, &seed) != 7) return 1;
  ldb = (N + 15) / 16 * 16;
  A.resize((size_t)M * K);
  B.resize((size_t)K * ldb);
  for (auto& v : A) { int x; scanf("%d", &x); v = (unsigned char)x; }
  for (auto& v : B) { int x; scanf("%d", &x); v = (unsigned char)x; }
  if (n == 8) return run<4>();
  if (n == 64) return run<32>();
  if (n == 128) return run<64>();
  if (n == 192) return run<96>();
  return 2;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the GEMM header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("gemm_sm90")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
        check=True, capture_output=True, text=True,
    )
    return str(exe)


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8], ids=["s8", "u8"])
@pytest.mark.parametrize("M,K,N", [
    (256, 2048, 256),  # P4 i8exact: four row groups of 64, two column tiles, eight K splits
    (8, 4096, 128),  # M = 8: one n = 8 group, 16 K splits
    (77, 1300, 90),  # ragged M, K and N: a short last word; five K splits asked, four of 384 .. 148 made
    (300, 640, 200),  # six ragged blocks, two K splits of 384 and 256
])
def test_gemm_blocks_and_split_fixup_match_plain(harness, M, K, N, dtype):
    groups, n = pp.gemm_groups(M)
    ksplit = pp.gemm_split_k(groups * -(-N // 128), K, SMS)
    rng = np.random.default_rng(M * 7 + K * 3 + N + (dtype == torch.uint8))
    a = rng.integers(0, 256, size=(M, K), dtype=np.int64)
    ldb = -(-N // 16) * 16
    b = rng.integers(0, 256, size=(K, ldb), dtype=np.int64)  # bytes past N: the storage's padding
    text = (f"{M} {N} {K} {int(dtype == torch.uint8)} {n} {ksplit} {M + K + N}\n"
            + " ".join(map(str, a.ravel())) + "\n" + " ".join(map(str, b.ravel())) + "\n")
    out = subprocess.run([harness], input=text, capture_output=True, text=True, check=True).stdout.split("\n")
    as_t = lambda x: torch.from_numpy(x.astype(np.uint8)).view(dtype)  # noqa: E731
    want = pp.int_gemm_plain(as_t(a), as_t(b[:, :N])).numpy()
    kper, splits = map(int, out[0].split())
    # every case splits K; the launcher rounds a split to 128 k, which may leave fewer
    assert 1 < splits <= ksplit and kper % 128 == 0 and kper * (splits - 1) < K <= kper * splits
    for order in range(3):
        got = np.array(out[2 * order + 1].split(), dtype=np.int64).reshape(M, N)
        assert np.array_equal(got, want), f"arrival order {order}"
    assert int(out[6]) == 0  # every tile counter back at 0 after each launch
