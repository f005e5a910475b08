// The register side of the Hopper byte-plane dots (plane_dot_sm90_kernel.cu,
// int_gemm_sm90_kernel.cu, both on sm90_dot.cuh): where each word lies in a
// stage's word tile, how a consumer thread builds its wgmma A-operand
// registers from the staged words with prmt (the signed byte planes of
// kernel A, the fake planes of its dot-only probe, or the plain bytes of a
// row-major GEMM operand), which (column, row) each accumulator register
// holds, and the K-major transpose of a stage that TMA loaded MN-major.
//
// The kernels compute a transposed tile D[column, row] =
// X^T[column, k] x A^T[k, row] with wgmma.mma_async.m64nNk32 (8-bit),
// X's columns as the M side (64 per warpgroup, from registers) and A's rows
// as the N side (from shared memory, K-major: the 8-bit wgmma reads no
// other shared-memory layout). The 8-bit A-from-register layout, per warp w
// of the warpgroup (its rows 16 w .. 16 w + 15), lane = 4 g + t:
//   reg 0: row g,     k 4t .. 4t + 3       reg 1: row g + 8, k 4t .. 4t + 3
//   reg 2: row g,     k 4t + 16 .. 4t + 19 reg 3: row g + 8, k 4t + 16 ..
// four consecutive k of one row per register, the lowest k in the lowest
// byte. X is staged as 32-bit words [k][word], so a word holds four X
// columns at one k, and a 4 x 4 byte transpose (four words at k 4t .. 4t + 3,
// prmt) gives a thread four adjacent columns. The fragment wants rows g and
// g + 8 in one thread, so the columns are permuted inside the warp's 16:
// row j <-> word 4 w + (j & 3), byte ("plane") j >> 2. Rows g and g + 8 are
// then bytes p and p + 2 of one word (p = g >> 2), and one set of four
// staged words gives both registers. The accumulator stores undo the
// permutation: kernel A writes column (plane L + word), kernel C the GEMM
// column 4 word + byte (int_gemm_sm90.cuh).
// The s32 accumulator layout of m64nN, register j < N / 2:
//   row g + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2t + (j & 1).
//
// Like the field headers it compiles as plain C++ too, where __byte_perm
// has a host definition, so tests/test_torch_csrc_plane_frags.py and
// tests/test_torch_csrc_gemm_sm90.py hold the layouts against the plain
// versions with g++.

#pragma once

#include "field_common.cuh"

namespace sm90 {

constexpr int KB = 128;       // k per stage: one 128-byte swizzle row of A
constexpr int WSUB = 16;      // words per consumer warpgroup (64 plane columns)
constexpr u32 SIGN = 0x80808080u;

// how a word tile becomes registers: kernel A's signed planes (byte XOR
// 0x80), its dot-only probe's fake planes (the low byte of each word for
// every plane, no XOR) or a GEMM operand's plain bytes (no XOR)
enum Frag { FRAG_SIGNED = 0, FRAG_FAKE = 1, FRAG_BYTES = 2 };

#ifndef __CUDACC__
// prmt's default mode: byte i of the result is byte (s >> 4 i) & 7 of the
// eight bytes {x, y} (x the low four)
inline u32 __byte_perm(u32 x, u32 y, u32 s) {
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  u32 r = 0;
  for (int i = 0; i < 4; ++i) r |= (u32)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
#endif

// The staged word tile of one stage, as TMA writes it: KB rows of wt words,
// each word `wstride` u32 (1: u32 words; 2: int64 lanes, low half first),
// rows packed; TMA zero-fills words past L and rows past the slice's end.
// The u32 index of word (k, col):
LF_DEV int w_index(int k, int col, int wt, int wstride) { return (k * wt + col) * wstride; }

// The same tile of 32 u32 words a row staged with TMA's 128-byte swizzle
// (the kernels' u32 instances): 16-byte chunk c of row k at chunk
// c ^ (k & 7). The fragment loads below then hit 8 banks a warp, not 4:
// a thread's four words lie in four consecutive rows of one column, and
// the unswizzled rows are 32 words, one bank, apart.
LF_DEV int w_index_sw(int k, int col) { return k * 32 + ((((col >> 2) ^ (k & 7))) << 2) + (col & 3); }

// Consumer: the staged column of the words a thread gathers, for sub-tile
// `ws` (WSUB words each), warp w of the warpgroup, lane
LF_DEV int frag_col(int ws, int w, int lane) { return WSUB * ws + 4 * w + ((lane >> 2) & 3); }

// the byte plane of register r's row (0 .. 3)
LF_DEV int frag_plane(int lane, int r) { return (lane >> 4) + 2 * (r & 1); }

// the k (within the 32-deep step) of byte i of register r
LF_DEV int frag_k(int lane, int r, int i) { return 4 * (lane & 3) + 16 * (r >> 1) + i; }

// byte `plane` of four words, packed with x0's byte lowest
LF_DEV u32 gather_bytes(u32 x0, u32 x1, u32 x2, u32 x3, int plane) {
  const u32 sel = (u32)plane | ((u32)(plane + 4) << 4);
  return __byte_perm(__byte_perm(x0, x1, sel), __byte_perm(x2, x3, sel), 0x5410);
}

// byte `plane` of four words, XOR 0x80 (the signed plane value)
LF_DEV u32 gather_plane(u32 x0, u32 x1, u32 x2, u32 x3, int plane) {
  return gather_bytes(x0, x1, x2, x3, plane) ^ SIGN;
}

// the four A-operand registers of 32-deep step `ks` from a staged word tile
// of `wt` words a row (SWZ: 32 u32 words a row, w_index_sw's swizzle)
template <int FRAG = FRAG_SIGNED, bool SWZ = false>
LF_DEV void plane_frags(u32 (&a)[4], const u32* w_s, int wt, int wstride, int col, int ks, int lane) {
  const int p = frag_plane(lane, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 32 * ks + 16 * h + 4 * (lane & 3);
    u32 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w_s[SWZ ? w_index_sw(k + i, col) : w_index(k + i, col, wt, wstride)];
    if (FRAG == FRAG_SIGNED) {
      a[2 * h] = gather_plane(x[0], x[1], x[2], x[3], p);
      a[2 * h + 1] = gather_plane(x[0], x[1], x[2], x[3], p + 2);
    } else if (FRAG == FRAG_FAKE) {
      a[2 * h] = a[2 * h + 1] = gather_bytes(x[0], x[1], x[2], x[3], 0);
    } else {
      a[2 * h] = gather_bytes(x[0], x[1], x[2], x[3], p);
      a[2 * h + 1] = gather_bytes(x[0], x[1], x[2], x[3], p + 2);
    }
  }
}

// accumulator register j: its plane (0 .. 3), its word within the
// warpgroup's 16, and its Ajtai row within the row group
LF_DEV int acc_plane(int lane, int j) { return (lane >> 4) + 2 * ((j >> 1) & 1); }
LF_DEV int acc_word(int w, int lane) { return 4 * w + ((lane >> 2) & 3); }
LF_DEV int acc_row(int lane, int j) { return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1); }

// ---------------------------------------------------------------------------
// The K-major transpose of a stage whose A tile TMA loaded MN-major (kernel
// A's K-major lhs [c, Ks, Mpad]): the raw tile is KB k-rows of n bytes (row r
// of A at byte r of its k-row); the copy is what desc_sw128 reads, n rows of
// KB bytes, 16-byte chunk (k >> 4) of row r at chunk (k >> 4) ^ (r & 7).
// ---------------------------------------------------------------------------

// the u32 index of bytes (row, k .. k + 3) in the swizzled K-major copy
LF_DEV int sw128_word(int row, int k) { return row * (KB / 4) + ((((k >> 4) ^ (row & 7))) << 2) + ((k & 15) >> 2); }

// One thread's 4 x 4 byte block: k-rows 4 kb .. 4 kb + 3 and rows 4 rb ..
// 4 rb + 3. Lane = 8 s + b of a warp takes kb = 4 q + s (one 16-k chunk q
// per warp) and rb = 8 G + b. It reads k-row 4 kb + ((i + s) & 3) at load
// i and writes row 4 rb + ((j + (b >> 1)) & 3) at store j: rotated so that
// the 32 lanes of a load or a store hit 32 distinct banks at n = 224 (a
// k-row's 224 bytes are a multiple of 32 words, so unrotated loads of one
// column of blocks would all hit one bank; the swizzle folds the rows of
// one store onto two chunks). The byte gather of register order is then a
// rotation by s bytes, one more prmt.
LF_DEV void transpose_block(const u32* raw, u32* dst, int n, int kb, int rb, int s, int b) {
  u32 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = raw[(4 * kb + ((i + s) & 3)) * (n >> 2) + rb];
  // byte t of a row's word is byte t - s of the gather in register order
  const u32 rot = (u32)((0 - s) & 3) | ((u32)((1 - s) & 3) << 4) | ((u32)((2 - s) & 3) << 8) |
                  ((u32)((3 - s) & 3) << 12);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jj = (j + (b >> 1)) & 3;
    const u32 g = gather_bytes(r[0], r[1], r[2], r[3], jj);
    dst[sw128_word(4 * rb + jj, 4 * kb)] = __byte_perm(g, g, rot);
  }
}

// the whole stage by 8 warps (the consumers): N a multiple of 32, units of
// (16-k chunk q, 32 rows G), warp w taking q = w and every G
template <int N>
LF_DEV void transpose_stage(const u32* raw, u32* dst, int warp, int lane) {
  const int s = lane >> 3, b = lane & 7;
#pragma unroll
  for (int g = 0; g < N / 32; ++g) transpose_block(raw, dst, N, 4 * warp + s, 8 * g + b, s, b);
}

}  // namespace sm90
