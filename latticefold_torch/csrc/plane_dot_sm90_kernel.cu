// Kernel A's dot, rebuilt for Hopper: the signed-int8 byte-plane dot of
// the Ajtai commit, per component c of one contraction slice,
//   P[c, m, b L + o] = sum_k A[c, m, k] * (int8)(byte b of (W[c, k, o] ^ 0x80808080)),
// with wgmma on TMA-loaded, mbarrier-tracked shared-memory stages
// (sm90_dot.cuh), in three modes: the full dot on a row-major lhs, the
// same dot on a K-major lhs, and the dot-only probe (fake planes).
//
// Replaces: latticefold_tpu/rings/pallas_commit.py `_fused_slice` (kernel
// `_dot_kernel`), which is benches/exp_r4_kvar.py `kern_v2`, and
// benches/exp_r4_kvar2.py `batched_kernel` (the same function with every c
// in one block; here the grid spans c); the probes exp_r4_kvar.py
// `kern_dot_only` (mode dot_only: every plane the low byte of its word, no
// XOR) and exp_r4_kvar3.py `kmajor_kernel` (the lhs stored K-major,
// [c, Ks, Mpad]). The mma.sync kernel (plane_dot_kernel.cu) keeps
// `planes_only` and is the in-call baseline of every mode here.
//
// What bounds it: per component it reads Mpad Ks bytes of A and Ks L words
// of W (8 bytes each as the port's int64 limb lanes) and does 2 Mpad Ks 4L
// int8 operations: 2 Mpad 4L / (Mpad + 8L) = 150 to 450 operations per
// byte at the commit's shapes (Mpad 224 .. Stark's 576), below the card's
// 1979e12 / 3.35e12 = 590, so device memory bounds it, and W's words are
// most of the bytes. (Counted at 4 bytes a word, the function itself is
// bound by operations at Stark's shape.) Each block reads its Ajtai tile
// once per word tile, so the A bytes it moves from L2 grow with L / WT.
// Inside a block, shared memory bounds a step before the tensor cores do:
// the fragment loads (four words in four rows of one column) conflict on
// the banks, so u32 words are staged with TMA's 128-byte swizzle (2-way
// instead of 4-way; plane_frags_sm90.cuh w_index_sw); int64 lanes' 256-byte
// rows exceed one swizzle span and stay as they lie. The K-major lhs adds
// more: the 8-bit wgmma reads K-major operands only, so each stage's
// MN-major tile is transposed in shared memory (4 x 4 byte blocks, prmt,
// bank-conflict-free at Mpad 224), once per block and stage, while the
// previous step's wgmma runs.
//
// Design (sm90_dot.cuh has the pipeline, plane_frags_sm90.cuh the register
// layouts and the transpose):
// - A block owns every Ajtai row of one row group of N <= 224 rows, a tile of
//   WT = 32 words and one K split, so W's words are read from device memory
//   once per row group: Mpad 224 is one group of 224, Frog's 416 two of 224,
//   Stark's 576 three of 192 (rings/plane_commit.py `sm90_groups`). (Every
//   row group in one block, sharing each staged W tile, was measured and
//   dropped: slower at both Mpad > 256 shapes; PERF.md. A width of 256
//   does not fit the register file: ptxas serializes its wgmmas.)
// - The transposed tile P^T[plane columns, rows] = planes^T x A^T runs on
//   wgmma.m64nNk32.s32.s8.s8: the M side is 64 plane columns (16 words x 4
//   byte planes) per consumer warpgroup, their A-operand registers built
//   from the staged words with prmt and the XOR 0x80808080, so the planes
//   never reach device or shared memory; the N side is the row group's
//   Ajtai rows, read by wgmma from shared memory, where they are K-major.
//   The block's two consumer warpgroups take word sub-tiles 0 and 1 (16
//   words each) and share each staged A tile.
// - The grid also splits K where the tiles alone leave SMs idle; the splits
//   add into `out` (zeroed by the caller) with int32 atomics, exact in any
//   order. Every sum is below 2^31 (|A|, |plane| <= 128, Ks <= 2^15).
//
// A   : [c, M, Ks] int8, strides (as0, as1, 1) bytes; K-major: [c, Ks, M]
// W   : [c, Ks, L] u32 words with element strides (ws0, ws1, 1), as u32
//       (wbytes 4) or as int64 lanes (wbytes 8)
// out : [c, M, 4L] int32, contiguous
// Pointers and the strides of A and W in bytes multiples of 16.

#include "sm90_dot.cuh"

// n: the row groups' width, chosen by the wrapper (rings/plane_commit.py
// `sm90_groups`); the grid spans the row groups of n rows that cover M.
// mode: 0 full, 2 dot only (rings/plane_commit.py MODES); kmajor: A is
// [c, Ks, M] (full mode only). An n, mode or layout without an instance
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int lf_plane_dot_sm90(const void* A, long long as0, long long as1, const void* W,
                                 long long ws0, long long ws1, int wbytes, void* out, int c, int M,
                                 int Ks, int L, int ksplit, int n, int mode, int kmajor, void* stream) {
  using namespace sm90;
  cudaStream_t s = (cudaStream_t)stream;
  if (ksplit < 1 || n < 1 || Ks < 1 || L < 1 || c < 1 || M < 1 || (wbytes != 4 && wbytes != 8) ||
      (mode != 0 && mode != 2) || (kmajor && mode != 0) ||
      (unsigned long long)A % 16 || as0 % 16 || as1 % 16 || (unsigned long long)W % 16 ||
      (ws0 * wbytes) % 16 || (ws1 * wbytes) % 16)
    return (int)cudaErrorInvalidValue;
  Out o{(int*)out, nullptr, nullptr, wbytes, M, Ks, L, 0, ksplit, 0};
  o.kper = split_k_per(Ks, o.ksplit);
  const int WT = Cfg<64, false, 8>::WT;
  const dim3 grid((L + WT - 1) / WT, o.ksplit * ((M + n - 1) / n), c);

  CUtensorMap amap, wmap;
  const bool amap_ok = kmajor ? tensor_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, M, Ks, c, as1, as0, n, KB,
                                           CU_TENSOR_MAP_SWIZZLE_NONE)
                              : tensor_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, Ks, M, c, as1, as0, KB, n,
                                           CU_TENSOR_MAP_SWIZZLE_128B);
  // u32 words: 128-byte rows of the word tile, swizzled (the LB 4
  // instances); int64 lanes as they lie (LB 8)
  if (!amap_ok ||
      !tensor_map(&wmap, wbytes == 8 ? CU_TENSOR_MAP_DATA_TYPE_UINT64 : CU_TENSOR_MAP_DATA_TYPE_UINT32, W, L, Ks,
                  c, ws1 * wbytes, ws0 * wbytes, WT, KB,
                  wbytes == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;

#define LF_SM90_LB(NN, LB)                                                                              \
  if (kmajor) return launch_dot<NN, true, FRAG_SIGNED, false, false, LB>(amap, wmap, o, grid, s);       \
  if (mode == 2) return launch_dot<NN, false, FRAG_FAKE, false, false, LB>(amap, wmap, o, grid, s);     \
  return launch_dot<NN, false, FRAG_SIGNED, false, false, LB>(amap, wmap, o, grid, s);
#define LF_SM90(NN)                       \
  if (n == NN) {                          \
    if (wbytes == 4) { LF_SM90_LB(NN, 4) } \
    LF_SM90_LB(NN, 8)                     \
  }
  LF_SM90(64)
  LF_SM90(128)
  LF_SM90(192)
  LF_SM90(224)
#undef LF_SM90
#undef LF_SM90_LB
  return (int)cudaErrorInvalidValue;
}
