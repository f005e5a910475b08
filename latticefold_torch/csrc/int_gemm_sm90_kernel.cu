// Kernel C on Hopper: a plain GEMM on the tensor cores, C = A B with
// A [M, K] and B [K, N] row-major, s8 x s8 or u8 x u8 -> int32, on
// wgmma.m64nNk32.s32.{s8,u8} with TMA-loaded stages (sm90_dot.cuh).
//
// Replaces: the TPU probes of the matrix unit that the commit's dot rests
// on: benches/exp_r4_probe.py `probe_i8exact` (i8 and u8 GEMMs, 256 x 2048
// x 256, and 8 x 2^15 x 128), `probe_dotspeed`'s Pallas grid dot (i8,
// 1728 x 2^15 x 384 and 1536) and benches/exp_pallas_probe.py's `dot_u8`
// (128 x 256 x 128). (`dot_u8_via_bf16` has a Hopper kernel of its own,
// bf16_gemm_sm90_kernel.cu; the first design of both, int_gemm_kernel.cu,
// is their in-call baseline.)
//
// What bounds it: 2 M N K operations on M K + K N bytes, 2 M N / (M + N)
// operations per byte: about 630 and 1630 at the dot-speed shapes (1728 x
// 384 and 1536), above the card's 1979e12 / 3.35e12 = 590, so the tensor
// cores; the other shapes are small and bound by a launch (about 5 us).
//
// What the design does about it (int_gemm_sm90.cuh has the block
// algorithm): the 8-bit wgmma reads shared-memory operands K-major only,
// and B arrives N-contiguous, so B is never staged for wgmma: the kernel
// computes C^T = B^T A^T, B's columns as the M side built into registers
// from TMA-staged 32-bit words with prmt (a 4 x 4 byte transpose per four
// words, the columns permuted in each warp's 16 so one gather serves both
// rows of a thread's fragment), A's rows as the N side from 128-byte
// swizzled K-major stages, four stages in flight. A block owns n rows of A
// (n = 8, 64, 128 or 192: M = 1728 is nine groups of 192, M = 8 one of 8)
// and 128 columns of B. Where those tiles leave SMs idle the grid splits K,
// and the splits reduce in the launch (a workspace and per-tile counters
// kept by the wrapper), so no second launch clears C.
//
// A : [M, K] int8 or uint8, row stride lda bytes
// B : [K, N], row stride ldb bytes (read as [K, ceil(N / 4)] u32 words)
// C : [M, N] int32, contiguous
// Pointers, lda and ldb multiples of 16 bytes.

#include "sm90_dot.cuh"

// type: 0 s8, 1 u8. n: the row groups' width (8, 64, 128, 192), chosen by
// the wrapper (rings/plane_probes.py `gemm_groups`). ksplit: the K splits;
// above 1, ws holds ceil(M / n) ceil(N / 128) ksplit n / 2 256 ints and
// counters one int per tile, all 0 (the kernel leaves them 0). Another
// type or n returns cudaErrorInvalidValue and launches nothing.
extern "C" int lf_int_gemm_sm90(const void* A, long long lda, const void* B, long long ldb, void* C, int M,
                                int N, int K, int type, int ksplit, int n, void* ws, void* counters,
                                void* stream) {
  using namespace sm90;
  cudaStream_t s = (cudaStream_t)stream;
  if (ksplit < 1 || n < 1 || M < 1 || N < 1 || K < 1 || (type != 0 && type != 1) ||
      (unsigned long long)A % 16 || lda % 16 || (unsigned long long)B % 16 || ldb % 16 || ldb < N || lda < K)
    return (int)cudaErrorInvalidValue;
  const int words = (N + 3) / 4;
  Out o{(int*)C, (int*)ws, (int*)counters, 4, M, K, words, N, ksplit, 0};
  o.kper = split_k_per(K, o.ksplit);
  if (o.ksplit > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  const int WT = Cfg<64, false, 4>::WT;
  const dim3 grid((words + WT - 1) / WT, o.ksplit * ((M + n - 1) / n), 1);

  CUtensorMap amap, wmap;
  if (!tensor_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, K, M, 1, lda, lda * M, KB, n,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT32, B, words, K, 1, ldb, ldb * K, WT, KB,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;

#define LF_GEMM_SM90(NN)                                                                              \
  if (n == NN) {                                                                                      \
    if (type == 1) return launch_dot<NN, false, FRAG_BYTES, true, true, 4>(amap, wmap, o, grid, s);   \
    return launch_dot<NN, false, FRAG_BYTES, false, true, 4>(amap, wmap, o, grid, s);                 \
  }
  LF_GEMM_SM90(8)
  LF_GEMM_SM90(64)
  LF_GEMM_SM90(128)
  LF_GEMM_SM90(192)
#undef LF_GEMM_SM90
  return (int)cudaErrorInvalidValue;
}
