// The block algorithm of kernel C's bf16 instance on Hopper
// (bf16_gemm_sm90_kernel.cu): C[M, N] = A[M, K] B[K, N], uint8 A and B
// (row-major) taken as bf16 values, float32 sums, float32 C (row-major).
//
// A block owns BM = 64 rows of C (one warpgroup's wgmma M) and BN = 32
// columns, and the whole K slab: K up to 3 KS (KS = 128), in SS = 1 .. 3
// slab steps of KS k. Every load of the slab is issued before any wait,
// 16 bytes a load where the rows allow it:
// - A: thread (warp w, lane 4 g + t) loads bytes 32 t .. 32 t + 31 of each
//   slab step of rows 16 w + g and 16 w + g + 8: a quad reads 128 bytes of
//   a row, two 16-byte chunks a thread a row.
// - B: thread i loads k-row i of each slab step, its BN bytes at the
//   block's columns.
// Those chunks are the MMA operands as they are, because the products'
// order along k is free (every sum is an integer; see below): the logical
// k of the MMA is a permutation of the physical k, chosen so that a
// thread's own A bytes are its A fragment.
//
// The MMA: wgmma.m64n32k16.f32.bf16.bf16, A from registers, B from shared
// memory MN-major (the 16-bit wgmma transposes B on the way: no byte
// transpose anywhere).
// - The A-from-register layout per warp: reg 0 row g, k 2t and 2t + 1
//   (the lower k in the low half); reg 1 row g + 8, the same k; regs 2, 3
//   the same at k + 8. Word s (0 .. 7) of a thread's 32 bytes of a row holds
//   physical k 32 t + 4 s + j (j = 0 .. 3) of the slab step, taken as
//   logical k 16 s + 2 t + (j & 1) + 8 (j >> 1): bytes 0, 1 are reg 0 (or 1)
//   of k-step s, bytes 2, 3 reg 2 (or 3). u8 -> bf16 is exact (8
//   significant bits), once per byte.
// - B is written as bf16 at its logical k-row into the no-swizzle MN-major
//   layout: 8 x 8 core matrices (8 k-rows of 8 columns, 16 bytes a row,
//   128 bytes), core (k / 8, n / 8) at ((k / 8) BN / 8 + n / 8) 128 bytes.
//   The descriptor's leading byte offset is the k direction's core stride
//   (BN / 8 x 128 bytes), its stride byte offset the n direction's (128).
// - float32 sums of products of u8 values are exact while every partial sum
//   stays below 2^24: 255^2 K < 2^24, K <= K_EXACT = 258. The launcher and
//   the wrapper refuse a larger K.
//
// The store: the accumulators of each 8-column group, registers 4 i + r,
// hold row g + 8 (r >> 1), column 8 i + 2 t + (r & 1). Threads t and t ^ 1
// trade two values each (shuffles), so that each holds four consecutive
// columns of one row: even t row g, odd t row g + 8, columns 8 i + 4 (t >>
// 1) .. + 3, one 16-byte store (scalar stores at a ragged edge).
//
// Plain C++ too (as int_gemm_sm90.cuh): tests/test_torch_csrc_gemm_bf16.py
// runs every block of the grid a thread at a time with g++ against
// plane_probes.bf16_gemm_plain.

#pragma once

#include "plane_frags_sm90.cuh"

#ifndef __CUDACC__
#include <cstring>
#endif

namespace bf16g {

constexpr int BM = 64;          // rows of C a block: one warpgroup's wgmma M
constexpr int BN = 32;          // columns of C a block: 8 blocks at 128 x 128
constexpr int NACC = BN / 2;    // float32 accumulators a thread
constexpr int THREADS = 128;    // one warpgroup
constexpr int KS = 128;         // k of a slab step: 32 bytes of a row a thread of a quad
constexpr int SS_MAX = 3;       // slab steps a block holds
constexpr int K_EXACT = 258;    // the largest K whose float32 sums are exact

// 16 bytes as four little-endian words
struct Chunk {
  u32 w[4];
};

// Bytes c .. c + 15 of row r of a row-major byte matrix (row stride ld),
// zero outside rows [0, R) and columns [0, C). vec: the pointer and ld are
// multiples of 16, so a whole chunk inside the matrix is one 16-byte load.
LF_DEV Chunk load_chunk(const unsigned char* p, long long ld, int r, int R, int c, int C, bool vec) {
  Chunk x = {{0u, 0u, 0u, 0u}};
  if (r >= R || c >= C) return x;
  const unsigned char* q = p + (long long)r * ld + c;
  if (vec && c + 16 <= C) {
#ifdef __CUDACC__
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(q));
    x.w[0] = v.x, x.w[1] = v.y, x.w[2] = v.z, x.w[3] = v.w;
#else
    std::memcpy(x.w, q, 16);
#endif
    return x;
  }
  const int n = C - c < 16 ? C - c : 16;
  for (int i = 0; i < n; ++i) x.w[i >> 2] |= (u32)q[i] << (8 * (i & 3));
  return x;
}

// the logical k (within a slab step) of physical k p
LF_DEV int k_logical(int p) {
  const int t = p >> 5, s = (p >> 2) & 7, j = p & 3;
  return 16 * s + 2 * t + (j & 1) + 8 * (j >> 1);
}

// the bf16 bits of a byte value (exact)
LF_DEV u32 bf16_of_byte(u32 b) {
  const float f = (float)b;
#ifdef __CUDACC__
  return __float_as_uint(f) >> 16;
#else
  u32 u;
  std::memcpy(&u, &f, 4);
  return u >> 16;
#endif
}

// two bytes of a word (byte `lo` and the next) as bf16 x 2, the lower first
LF_DEV u32 bf16x2(u32 w, int lo) {
  return bf16_of_byte((w >> (8 * lo)) & 0xFF) | (bf16_of_byte((w >> (8 * lo + 8)) & 0xFF) << 16);
}

// k-step s's A fragment from word s of the thread's rows g (w0) and g + 8 (w1)
LF_DEV void a_frag(u32 (&a)[4], u32 w0, u32 w1) {
  a[0] = bf16x2(w0, 0);
  a[1] = bf16x2(w1, 0);
  a[2] = bf16x2(w0, 2);
  a[3] = bf16x2(w1, 2);
}

// the bf16 index of (logical k, column n) in the MN-major stage of BN columns
LF_DEV int b_index(int k, int n) { return (((k >> 3) * (BN >> 3) + (n >> 3)) << 6) + ((k & 7) << 3) + (n & 7); }

// the stage's descriptor fields in bytes: k-step s starts at s DESC_STEP,
// the next 8 k-rows lie DESC_LBO further (k direction), the next 8 columns
// DESC_SBO
constexpr int DESC_LBO = (BN >> 3) * 128;
constexpr int DESC_STEP = 2 * DESC_LBO;
constexpr int DESC_SBO = 128;

// --------------------------------------------------------------------------
// the store
// --------------------------------------------------------------------------

// what a thread sends its partner (lane ^ 1) of one 8-column group's
// registers v: an even t the row g + 8 pair, an odd t the row g pair
LF_DEV void quad_send(const float (&v)[4], bool odd, float& x0, float& x1) {
  x0 = odd ? v[0] : v[2];
  x1 = odd ? v[1] : v[3];
}

// its four consecutive columns once it has the partner's pair (y0, y1)
LF_DEV void quad_out(const float (&v)[4], bool odd, float y0, float y1, float (&o)[4]) {
  o[0] = odd ? y0 : v[0];
  o[1] = odd ? y1 : v[1];
  o[2] = odd ? v[2] : y0;
  o[3] = odd ? v[3] : y1;
}

// the row (within the block) and column (within the block) of that store
LF_DEV int out_row(int warp, int lane) { return 16 * warp + (lane >> 2) + 8 * (lane & 1); }
LF_DEV int out_col(int i, int lane) { return 8 * i + 4 * ((lane & 3) >> 1); }

}  // namespace bf16g
