// The witness side of kernel A's Hopper dot (plane_dot_sm90_kernel.cu):
// where each word lies in a stage's word tile, how a consumer thread builds its
// wgmma A-operand registers (the signed byte planes) from the staged words,
// and which (plane column, Ajtai row) each accumulator register holds.
//
// The kernel computes the transposed tile P^T[plane column, row] =
// planes^T[plane column, k] x A^T[k, row] with
// wgmma.mma_async.m64nNk32.s32.s8.s8, the planes as the M side (64 plane
// columns per warpgroup, from registers) and the Ajtai rows as the N side
// (from shared memory). The 8-bit A-from-register layout, per warp w of the
// warpgroup (its rows 16 w .. 16 w + 15), lane = 4 g + t:
//   reg 0: row g,     k 4t .. 4t + 3       reg 1: row g + 8, k 4t .. 4t + 3
//   reg 2: row g,     k 4t + 16 .. 4t + 19 reg 3: row g + 8, k 4t + 16 ..
// four consecutive k of one row per register, the lowest k in the lowest
// byte. A warp's 16 rows are 4 words x 4 planes: row j <-> word 4 w + (j & 3),
// plane j >> 2. So rows g and g + 8 are planes p and p + 2 of one word
// (p = g >> 2), and one set of four staged words gives both registers.
// The s32 accumulator layout of m64nN, register j < N / 2:
//   row g + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2t + (j & 1).
//
// Like the field headers it compiles as plain C++ too, where __byte_perm
// has a host definition, so tests/test_torch_csrc_plane_frags.py holds the
// layout against the plain planes with g++.

#pragma once

#include "field_common.cuh"

namespace sm90 {

constexpr int KB = 128;       // k per stage: one 128-byte swizzle row of A
constexpr int WSUB = 16;      // words per consumer warpgroup (64 plane columns)
constexpr u32 SIGN = 0x80808080u;

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

// Consumer: the staged column of the words a thread gathers, for sub-tile
// `ws` (WSUB words each), warp w of the warpgroup, lane
LF_DEV int frag_col(int ws, int w, int lane) { return WSUB * ws + 4 * w + ((lane >> 2) & 3); }

// the byte plane of register r's row (0 .. 3)
LF_DEV int frag_plane(int lane, int r) { return (lane >> 4) + 2 * (r & 1); }

// the k (within the 32-deep step) of byte i of register r
LF_DEV int frag_k(int lane, int r, int i) { return 4 * (lane & 3) + 16 * (r >> 1) + i; }

// byte `plane` of four words, XOR 0x80 (the signed plane value), packed with
// x0's byte lowest
LF_DEV u32 gather_plane(u32 x0, u32 x1, u32 x2, u32 x3, int plane) {
  const u32 sel = (u32)plane | ((u32)(plane + 4) << 4);
  return __byte_perm(__byte_perm(x0, x1, sel), __byte_perm(x2, x3, sel), 0x5410) ^ SIGN;
}

// the four A-operand registers of 32-deep step `ks` from a staged word tile
// of `wt` words a row
LF_DEV void plane_frags(u32 (&a)[4], const u32* w_s, int wt, int wstride, int col, int ks, int lane) {
  const int p = frag_plane(lane, 0);
  const int pitch = wt * wstride;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const u32* q = w_s + w_index(32 * ks + 16 * h + 4 * (lane & 3), col, wt, wstride);
    const u32 x0 = q[0], x1 = q[pitch], x2 = q[2 * pitch], x3 = q[3 * pitch];
    a[2 * h] = gather_plane(x0, x1, x2, x3, p);
    a[2 * h + 1] = gather_plane(x0, x1, x2, x3, p + 2);
  }
}

// accumulator register j: its plane (0 .. 3), its word within the
// warpgroup's 16, and its Ajtai row within the row group
LF_DEV int acc_plane(int lane, int j) { return (lane >> 4) + 2 * ((j >> 1) & 1); }
LF_DEV int acc_word(int w, int lane) { return 4 * w + ((lane >> 2) & 3); }
LF_DEV int acc_row(int lane, int j) { return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1); }

}  // namespace sm90
