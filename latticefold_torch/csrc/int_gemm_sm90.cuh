// The block algorithm of kernel C's Hopper GEMM (int_gemm_sm90_kernel.cu):
// C[M, N] = A[M, K] B[K, N] (s8 or u8, int32 sums), A and B row-major,
// computed as C^T = B^T A^T on sm90_dot.cuh's pipeline.
//
// - B is N-contiguous, so it is read as 32-bit words [K][N / 4]: word o of
//   a k-row holds columns 4 o .. 4 o + 3. TMA stages [128 k][32 words]
//   boxes, and plane_frags<FRAG_BYTES> (plane_frags_sm90.cuh) builds each
//   consumer's wgmma A-operand registers from them with prmt, as kernel A
//   does for the witness words but with no XOR: B's columns are the wgmma
//   M side, 64 a warpgroup, permuted inside each warp's 16 so that the 4 x 4
//   byte transpose of four staged words serves rows g and g + 8.
// - A is K-contiguous, so its rows are the wgmma N side (n = 8 .. 192 a
//   block), read from 128-byte-swizzled K-major stages as kernel A's Ajtai
//   rows are. M = 8 is one n = 8 block, not 64 padded rows.
// - The accumulators hold C^T; `gemm_col` undoes the column permutation and
//   the stores write C (row-major) from them.
// - K splits reduce in the same launch: each split writes its partial tile
//   to a workspace, a per-tile counter elects the last split to arrive, and
//   that split adds the other partials to its registers, writes C and puts
//   the counter back to 0 for the next launch. int32 sums are exact in any
//   order.
//
// Plain C++ too (as plane_frags_sm90.cuh): tests/test_torch_csrc_gemm_sm90.py
// runs the register build, the permuted stores and the split fixup with the
// splits arriving in seeded random orders against int_gemm_plain with g++.

#pragma once

#include "plane_frags_sm90.cuh"

namespace sm90 {

constexpr int GEMM_THREADS = 256;  // consumer threads of a block (two warpgroups)

// the C column (within the block's 4 WT) of accumulator register j of
// consumer thread (word sub-tile ws, warp w of its warpgroup, lane)
LF_DEV int gemm_col(int ws, int w, int lane, int j) { return 4 * (WSUB * ws + acc_word(w, lane)) + acc_plane(lane, j); }

// a tile's index: row group major
LF_DEV int gemm_tile(int rgroup, int ctile, int ctiles) { return rgroup * ctiles + ctile; }

// The workspace: per (tile, split) a slot of R registers x 256 consumer
// threads; register quad q of thread ct at int4 q 256 + ct, so a thread's
// stores and loads are 16 bytes and a warp's are coalesced.
LF_DEV long long ws_slot(int tile, int split, int ksplit, int R) {
  return ((long long)tile * ksplit + split) * R * GEMM_THREADS;
}
LF_DEV int ws_elem(int j, int ct) { return ((j >> 2) * GEMM_THREADS + ct) * 4 + (j & 3); }

#ifdef __CUDACC__
LF_DEV void st4(int* p, int a, int b, int c, int d) { *(int4*)p = make_int4(a, b, c, d); }
#else
inline void st4(int* p, int a, int b, int c, int d) { p[0] = a, p[1] = b, p[2] = c, p[3] = d; }
#endif

// a split's partial: every register of consumer thread ct into its slot
template <int R>
LF_DEV void ws_store(int* slot, const int (&acc)[R], int ct) {
#pragma unroll
  for (int j = 0; j < R; j += 4) st4(slot + ws_elem(j, ct), acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
}

// the k of each split (a multiple of KB) when Ks is cut into ksplit
// splits; ksplit becomes the number of splits the rounding leaves (the
// launchers of both kernels on sm90_dot.cuh; host code)
inline int split_k_per(int Ks, int& ksplit) {
  int kper = (Ks + ksplit - 1) / ksplit;
  kper = ((kper + KB - 1) / KB) * KB;
  ksplit = (Ks + kper - 1) / kper;
  return kper;
}

// the split whose counter ticket (the counter's value before its own
// increment) is `ticket` arrived last
LF_DEV bool last_split(int ticket, int ksplit) { return ticket == ksplit - 1; }

// The last split: add every other split's partial to its own registers.
// `ld4(v, p)` reads four workspace ints (on the card one 16-byte load
// through L2, __ldcg: the partials were written by other SMs). The loads
// go in rounds of F int4 (QC quads of U splits) in flight, so a thread
// waits for L2 once a round, not once a split.
template <int R, class Load4>
LF_DEV void fixup_sum(int (&acc)[R], const int* ws, int tile, int split, int ksplit, int ct, Load4 ld4) {
  constexpr int Q = R / 4, F = R > 64 ? 8 : R > 32 ? 16 : 32;
  constexpr int QC = Q < F ? Q : F, U = F / QC;
#pragma unroll
  for (int q0 = 0; q0 < Q; q0 += QC) {
    for (int sp0 = 0; sp0 < ksplit; sp0 += U) {
      int v[U][QC][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int sp = sp0 + u;
        const bool use = sp < ksplit && sp != split;
        const int* p = ws + ws_slot(tile, use ? sp : split, ksplit, R);
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          if (use) {
            ld4(v[u][q], p + ws_elem(4 * (q0 + q), ct));
          } else {
            v[u][q][0] = v[u][q][1] = v[u][q][2] = v[u][q][3] = 0;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < QC; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[4 * (q0 + q) + i] += v[u][q][i];
    }
  }
}

}  // namespace sm90
