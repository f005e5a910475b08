"""Kernel C's bf16 instance on Hopper (latticefold_torch/csrc/bf16_gemm_sm90.cuh)
against ``bf16_gemm_plain``, on the CPU.

The header compiles as plain C++ too, so a small harness built with g++
runs every block of the kernel's grid a thread at a time: each thread's
loads of its block's whole K slab (``load_chunk``: 16-byte chunks of A's
rows and B's k-rows, zero past M, K and N; the operands' storage padded
past K and N with garbage bytes), B's k-rows written as bf16 at their
logical k (``k_logical``) into the MN-major stage (``b_index``), A's words
made the wgmma register fragments (``a_frag``), and the product taken as
the 16-bit wgmma reads them: A from the register layout, B through the
descriptor's fields (``DESC_STEP``, ``DESC_LBO``, ``DESC_SBO``) in the
no-swizzle MN-major canonical layout, float32 sums; then the store: each
pair of lanes trades two values (``quad_send``, ``quad_out``) and writes
four columns of one row (``out_row``, ``out_col``), masked at M and N. C,
as float32 bits, must equal ``bf16_gemm_plain``'s, every element written
exactly once. The shared memory, the wgmma and the shuffles are the card's
work: chip_smoke.py holds the kernel itself against ``bf16_gemm_plain``.

Tolerance: exact equality (float32 bits) -- every sum is an integer; at
K <= 258 every partial sum is below 2^24."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from latticefold_torch import cuda
from latticefold_torch.rings import plane_probes as pp

HARNESS = r"""
#include <cmath>
#include <cstdio>
#include <cstring>
#include <vector>
#include "bf16_gemm_sm90.cuh"

using namespace bf16g;

int M, N, K, lda, ldb;
std::vector<unsigned char> A, B;

float f_of(u32 bits) { float f; std::memcpy(&f, &bits, 4); return f; }
u32 bits_of(float f) { u32 u; std::memcpy(&u, &f, 4); return u; }

int main() {
  if (scanf("%d %d %d %d %d", &M, &N, &K, &lda, &ldb) != 5) return 1;
  A.resize((size_t)M * lda);
  B.resize((size_t)K * ldb);
  for (auto& v : A) { int x; if (scanf("%d", &x) != 1) return 1; v = (unsigned char)x; }
  for (auto& v : B) { int x; if (scanf("%d", &x) != 1) return 1; v = (unsigned char)x; }
  if (K > K_EXACT) { printf("refused\n"); return 0; }
  const bool va = lda % 16 == 0, vb = ldb % 16 == 0, vc = N % 4 == 0;
  const int SS = (K + KS - 1) / KS;
  std::vector<float> C((size_t)M * N, NAN);
  std::vector<int> writes((size_t)M * N, 0);
  static Chunk a_raw[THREADS][SS_MAX][2][2], b_raw[THREADS][SS_MAX][BN / 16];
  static u32 a[THREADS][SS_MAX][8][4];
  static float out[THREADS][NACC];
  for (int by = 0; by < (M + BM - 1) / BM; ++by)
    for (int bx = 0; bx < (N + BN - 1) / BN; ++bx) {
      const int m0 = by * BM, n0 = bx * BN;
      for (int tid = 0; tid < THREADS; ++tid) {
        const int warp = tid >> 5, lane = tid & 31, r0 = m0 + 16 * warp + (lane >> 2);
        for (int c = 0; c < SS; ++c) {
          for (int h = 0; h < 2; ++h)
            for (int q = 0; q < 2; ++q)
              a_raw[tid][c][h][q] = load_chunk(A.data(), lda, r0 + 8 * h, M, KS * c + 32 * (lane & 3) + 16 * q, K, va);
          for (int q = 0; q < BN / 16; ++q)
            b_raw[tid][c][q] = load_chunk(B.data(), ldb, KS * c + tid, K, n0 + 16 * q, N, vb);
        }
      }
      // the stage, every bf16 first a NaN: a cell no thread wrote poisons the sums
      std::vector<unsigned short> bs((size_t)SS * KS * BN, 0x7FC0);
      for (int tid = 0; tid < THREADS; ++tid)
        for (int c = 0; c < SS; ++c) {
          const int k = KS * c + k_logical(tid);
          for (int q = 0; q < BN / 16; ++q)
            for (int e = 0; e < 2; ++e) {
              const u32 w0 = b_raw[tid][c][q].w[2 * e], w1 = b_raw[tid][c][q].w[2 * e + 1];
              const u32 v[4] = {bf16x2(w0, 0), bf16x2(w0, 2), bf16x2(w1, 0), bf16x2(w1, 2)};
              std::memcpy(&bs[b_index(k, 16 * q + 8 * e)], v, 16);
            }
          for (int s = 0; s < 8; ++s)
            a_frag(a[tid][c][s], a_raw[tid][c][0][s >> 2].w[s & 3], a_raw[tid][c][1][s >> 2].w[s & 3]);
        }
      const unsigned char* stage = (const unsigned char*)bs.data();
      for (int tid = 0; tid < THREADS; ++tid) {
        const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
        for (int j = 0; j < NACC; ++j) {
          const int r16 = g + 8 * ((j >> 1) & 1), col = 8 * (j >> 2) + 2 * t + (j & 1);
          float acc = 0.0f;
          for (int c = 0; c < SS; ++c)
            for (int s = 0; s < 8; ++s)
              for (int kk = 0; kk < 16; ++kk) {
                // A: the register layout of m64nNk16 (reg = row half + 2 k half)
                const int src = 32 * warp + 4 * (r16 & 7) + ((kk & 7) >> 1);
                const u32 reg = a[src][c][s][(r16 >> 3) + 2 * (kk >> 3)];
                const float av = f_of(((reg >> (16 * (kk & 1))) & 0xFFFF) << 16);
                // B: the no-swizzle MN-major canonical layout through the descriptor's fields
                const int byte = (8 * c + s) * DESC_STEP + (kk >> 3) * DESC_LBO + (col >> 3) * DESC_SBO +
                                 (kk & 7) * 16 + (col & 7) * 2;
                unsigned short bv;
                std::memcpy(&bv, stage + byte, 2);
                acc += av * f_of((u32)bv << 16);
              }
          out[tid][j] = acc;
        }
      }
      for (int tid = 0; tid < THREADS; ++tid) {
        const int warp = tid >> 5, lane = tid & 31;
        const bool odd = lane & 1;
        const int row = m0 + out_row(warp, lane);
        for (int i = 0; i < BN / 8; ++i) {
          const float v[4] = {out[tid][4 * i], out[tid][4 * i + 1], out[tid][4 * i + 2], out[tid][4 * i + 3]};
          const float* q = out[tid ^ 1];
          const float pv[4] = {q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]};
          float y0, y1, o[4];
          quad_send(pv, !odd, y0, y1);  // what the partner (lane ^ 1) sends
          quad_out(v, odd, y0, y1, o);
          const int col = n0 + out_col(i, lane);
          if (row >= M) continue;
          const bool whole = vc && col + 4 <= N;
          for (int e = 0; e < 4; ++e)
            if (whole || col + e < N) { C[(size_t)row * N + col + e] = o[e]; ++writes[(size_t)row * N + col + e]; }
        }
      }
    }
  int bad = 0;
  for (int w : writes) bad += w != 1;
  printf("%d\n", bad);
  for (float v : C) printf("%u ", bits_of(v));
  printf("\n");
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the bf16 GEMM header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("gemm_bf16")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
        check=True, capture_output=True, text=True,
    )
    return str(exe)


def run(harness, a, b, K, N):
    """The harness on the storage a [M, lda], b [K, ldb] (bytes past K and
    N are padding) -> (output lines)."""
    (M, lda), ldb = a.shape, b.shape[1]
    text = (f"{M} {N} {K} {lda} {ldb}\n" + " ".join(map(str, a.ravel())) + "\n"
            + " ".join(map(str, b.ravel())) + "\n")
    return subprocess.run([harness], input=text, capture_output=True, text=True, check=True).stdout.split("\n")


def operands(M, K, N, lda, ldb, seed, full=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(M, lda), dtype=np.int64)
    b = rng.integers(0, 256, size=(K, ldb), dtype=np.int64)
    if full:  # all-255 operands (the padding stays random)
        a[:, :K] = 255
        b[:, :N] = 255
    return a, b


@pytest.mark.parametrize("M,K,N,lda,ldb,full", [
    (128, 128, 128, 128, 128, False),  # the probe's shape: 8 blocks of 64 x 32
    (130, 64, 100, 64, 112, False),  # M and N past whole blocks, K half a slab step; B padded to 16-byte rows
    (72, 200, 40, 200, 40, False),  # ragged: rows of A and B not 16-byte multiples (byte loads)
    (72, 200, 40, 208, 48, False),  # the same in padded 16-byte rows (vector loads, garbage past K and N)
    (16, 1, 8, 16, 16, False),  # K 1: one k-row, the rest of the slab zero
    (64, 129, 32, 144, 32, False),  # K 129: a second slab step holding one k-row
    (128, 256, 128, 256, 128, True),  # all 255 at K 256: sums 16646400, 2^24 - 130816
    (64, 258, 30, 272, 32, True),  # all 255 at the largest exact K, 258; N 30: scalar stores
])
def test_bf16_gemm_blocks_match_plain(harness, M, K, N, lda, ldb, full):
    a, b = operands(M, K, N, lda, ldb, M * 7 + K * 3 + N, full)
    out = run(harness, a, b, K, N)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x).astype(np.uint8))  # noqa: E731
    want = pp.bf16_gemm_plain(t(a[:, :K]), t(b[:, :N])).numpy()
    assert int(out[0]) == 0  # every element of C written exactly once
    got = np.array(out[1].split(), dtype=np.uint32).reshape(M, N).view(np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_launcher_refuses_k_past_exact_float32(harness):
    a, b = operands(8, 259, 16, 259, 16, 9)
    assert run(harness, a, b, 259, 16)[0] == "refused"
