// Index maps of the tensor-core CRT/ICRT (crt_tc_kernel.cu): the order of
// the conv-folded byte matrix C and its layout in a shared-memory chunk,
// which limb of which element each wgmma A-operand register holds, which
// (element, output, byte position) each accumulator register holds, where it
// is staged, and the per-output finish (carry and wide reduction).
//
// The kernel computes, per element n (a row) and output o,
//   Y[n, (o, s)] = sum_k xbytes[n, k] C[k, (o, s)]     (u8 x u8 -> s32)
// with k = 4 (i nl + l) + b the byte b of limb l of input i, and (o, s) the
// byte position s < 8 nl of output o (rings/ops.py `conv_matrix`). So four
// consecutive k are one u32 limb, the low half of one int64 lane of the
// input: an 8-bit A-operand register of wgmma (four consecutive k of one
// row, the lowest k in the lowest byte) is loaded as that half, with no
// byte shuffling.
//
// Layouts, per warp w of a consumer warpgroup (its rows 16 w .. 16 w + 15),
// lane = 4 g + t:
//   A register r of 32-deep step ks: row g + 8 (r & 1), k 32 ks + 4 t +
//     16 (r >> 1) .. + 3, i.e. limb 8 ks + t + 4 (r >> 1);
//   s32 accumulator register j of m64n128: row g + 8 ((j >> 1) & 1),
//     column 8 (j >> 2) + 2 t + (j & 1)
// (the 8-bit wgmma layouts plane_frags_sm90.cuh uses too). A chunk of C is
// COLS = 128 columns, the byte positions of 128 / (8 nl) outputs, each
// column's k a 128-byte row per k block of 128, in the 128-byte swizzle.
//
// Like the field headers it compiles as plain C++ too (field_common.cuh),
// so tests/test_torch_csrc_crt_tc.py emulates one warpgroup's registers
// with g++ and holds them against numpy and Python integers.

#pragma once

#include "plane_epilogue.cuh"

#ifndef __CUDACC__
struct int4 {
  int x, y, z, w;
};
#endif

namespace crt_tc {

constexpr int COLS = 128;             // columns of a chunk of C: the wgmma N
constexpr int KB = 128;               // k of one 128-byte row of a k block
constexpr int KB_BYTES = COLS * KB;   // one k block of a chunk
constexpr int ROWS = 64;              // elements per consumer warpgroup: the wgmma M
constexpr int PITCH = COLS + 8;       // staged s32 words per element (8-byte stores hit 32 banks)

template <int NL, int D>
struct Shape {
  static constexpr int DNL = D * NL;                   // u32 limbs per element
  static constexpr int K = 4 * DNL;                    // bytes per element: the dot's depth
  static constexpr int KS = K / 32;                    // 32-deep wgmma steps
  static constexpr int SP = 8 * NL;                    // byte positions per output (the last is zero)
  static constexpr int CPC = COLS / SP;                // outputs per chunk
  static constexpr int NCH = (D + CPC - 1) / CPC;      // chunks
  static constexpr int NKB = (KS + 3) / 4;             // k blocks per chunk
  static constexpr int CHUNK_BYTES = NKB * KB_BYTES;
  static constexpr int PAIRS = ROWS * CPC / 128;       // (element, output) pairs per thread per chunk
  static_assert(K % 32 == 0, "the dot's depth must be whole 32-deep steps");
  static_assert(COLS % SP == 0 && (ROWS * CPC) % 128 == 0, "a chunk holds whole outputs");
};

// C's row of byte b of limb l of input i
LF_DEV int conv_k(int nl, int i, int l, int b) { return 4 * (i * nl + l) + b; }

// the 128-byte swizzle: 16-byte group g of a 128-byte row r (of a
// 1024-byte-aligned tile) lies at group g ^ (r % 8)
LF_DEV int swizzle128(int off) { return off ^ (((off >> 7) & 7) << 4); }

// byte (k, chunk column n) of chunk ch in the device layout (rings/ops.py
// `conv_tiles`), which the kernel copies into shared memory as it is
LF_DEV int conv_offset(int chunk_bytes, int ch, int n, int k) {
  return ch * chunk_bytes + (k / KB) * KB_BYTES + swizzle128(n * KB + k % KB);
}

// the start, within a chunk, of the B operand of 32-deep step ks: the
// wgmma descriptor's address (8-row groups 1024 bytes apart, the swizzle
// applied by the hardware on the full address)
LF_DEV int b_step(int ks) { return (ks / 4) * KB_BYTES + 32 * (ks % 4); }

// C's column of byte position s of output o (sp = 8 nl positions an
// output): its chunk, and its column within the chunk
LF_DEV int col_chunk(int sp, int o) { return o / (COLS / sp); }
LF_DEV int col_in_chunk(int sp, int o, int s) { return (o % (COLS / sp)) * sp + s; }

// A operand: the element row (within the warpgroup's ROWS) and the u32 limb
// (within the element's D NL) of register r of step ks
LF_DEV int a_row(int w, int lane, int r) { return 16 * w + (lane >> 2) + 8 * (r & 1); }
LF_DEV int a_limb(int lane, int ks, int r) { return 8 * ks + (lane & 3) + 4 * (r >> 1); }

// accumulator register j: its element row and chunk column
LF_DEV int acc_row(int w, int lane, int j) { return 16 * w + (lane >> 2) + 8 * ((j >> 1) & 1); }
LF_DEV int acc_col(int lane, int j) { return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1); }

// where the warpgroup stages (row, chunk column), in s32 words
LF_DEV int stage_index(int row, int col) { return row * PITCH + col; }

// the finish: pair p (thread + 128 it) of a chunk is output p % cpc of row
// p / cpc, so neighbouring threads write neighbouring outputs of one element
LF_DEV int pair_row(int cpc, int p) { return p / cpc; }
LF_DEV int pair_out(int cpc, int p) { return p % cpc; }

// one output's 8 NL byte-position sums (each below 2^31; the last is
// always zero), four a limb -> T as 2NL+1 u32 limbs and a zero guard
// limb, as carry_pack does, a limb at a time: limb L takes u[4L .. 4L+3] at
// shifts 0, 8, 16, 24 (their sum below 2^57) and the carry of limb L - 1,
// so the carry chain is 2NL+1 steps, not 8NL+4
template <int NL>
LF_DEV void carry_limbs(const int4* u, u32* t) {
  constexpr int LIMBS = 2 * NL + 1;
  u64 carry = 0;
#pragma unroll
  for (int L = 0; L < LIMBS; ++L) {
    u64 w = carry;
    if (L < 2 * NL) {
      const int4 q = u[L];
      w += (u64)(u32)q.x + ((u64)(u32)q.y << 8) + ((u64)(u32)q.z << 16) + ((u64)(u32)q.w << 24);
    }
    t[L] = (u32)w;
    carry = w >> 32;
  }
  t[LIMBS] = 0;
}

// one output's staged position sums -> its NL Montgomery limbs
template <int NL>
LF_DEV void finish_output(const int4* u, const WideRedc<NL>& wr, u32 (&out)[NL]) {
  u32 t[2 * NL + 2];
  carry_limbs<NL>(u, t);
  wr.reduce(t, out);
}

}  // namespace crt_tc
