// Kernel C's first design: a plain GEMM on the tensor cores, C = A B with
// A [M, K] and B [K, N] row-major, in three instances:
//   0: int8  x int8  -> int32  (mma.sync m16n8k32 .s8.s8)
//   1: uint8 x uint8 -> int32  (mma.sync m16n8k32 .u8.u8)
//   2: uint8 values as bf16 -> float32 (mma.sync m16n8k16 .bf16, f32 sums)
//
// Replaces: the TPU probes of the matrix unit that the commit's dot rests
// on: benches/exp_r4_probe.py `probe_i8exact` (i8 and u8 GEMMs, 256 x 2048
// x 256, and 8 x 2^15 x 128), `probe_dotspeed`'s Pallas grid dot (i8,
// 1728 x 2^15 x 384 and 1536) and benches/exp_pallas_probe.py's `dot_u8`
// (128 x 256 x 128) and `dot_u8_via_bf16` (128 x 128 x 128). Since its
// Hopper redesigns (int_gemm_sm90_kernel.cu for s8 and u8,
// bf16_gemm_sm90_kernel.cu for bf16) it is their in-call baseline
// (plane_probes.int_gemm_mma, bf16_gemm_mma), launched by no path.
//
// What bounds it: 2 M N K operations on M K + K N bytes, 2 M N / (M + N)
// operations per byte: about 630 and 1630 at the dot-speed shapes (1728 x
// 384 and 1536), above the card's 1979e12 / 3.35e12 = 590, so the tensor
// cores; the other shapes are small and launch-bound.
// Design: a block owns a 64 x 64 tile of C, four warps 32 x 32 each; per
// 64-deep step it stages A's tile (K-contiguous) and B's tile transposed
// (B is N-contiguous; the fragments want K-contiguous columns) in shared
// memory, the next step's loads in flight while this one computes
// (mma_tile.cuh). Rows, columns and K past the ends are zero-filled
// and masked, so M = 8 is padded inside the kernel. The grid's third axis
// splits K when the tile grid alone would leave SMs idle; the splits add
// into C (zeroed by the caller) with atomics, which is exact in any order:
// int32 sums, and float32 sums of integers below 2^24.

#include <type_traits>

#include "mma_tile.cuh"

namespace {

using namespace mma;

constexpr int THREADS = 128;

template <int T>
__global__ void __launch_bounds__(THREADS)
    int_gemm_kernel(const unsigned char* __restrict__ A, long long lda,
                    const unsigned char* __restrict__ B, long long ldb, void* __restrict__ C,
                    long long ldc, int M, int N, int K, int kper, bool vec) {
  __shared__ __align__(16) unsigned char a_s[TILE * PITCH];
  __shared__ __align__(16) unsigned char b_s[TILE * PITCH];
  typedef typename std::conditional<T == 2, float, int>::type Acc;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const int kb = blockIdx.z * kper;
  const int ke = min(K, kb + kper);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mw = (warp >> 1) * 32, nw = (warp & 1) * 32;

  Acc acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  TileLoader<THREADS, false> a_ld;
  TileLoader<THREADS, true> b_ld;  // B [K, N] is N-contiguous: its tile is transposed
  a_ld.fetch(A, lda, m0, M, kb, ke, vec);
  b_ld.fetch(B, ldb, n0, N, kb, ke, vec);
  for (int k0 = kb; k0 < ke; k0 += TILE) {
    __syncthreads();
    a_ld.store(a_s);
    b_ld.store(b_s);
    __syncthreads();
    if (k0 + TILE < ke) {
      a_ld.fetch(A, lda, m0, M, k0 + TILE, ke, vec);
      b_ld.fetch(B, ldb, n0, N, k0 + TILE, ke, vec);
    }
    if constexpr (T == 2) {
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 16) {
        u32 a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) frag_a16(a[mi], a_s, mw + 16 * mi, kk, lane);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) frag_b16(b[ni], b_s, nw + 8 * ni, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 32) {
        u32 a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) frag_a8(a[mi], a_s, mw + 16 * mi, kk, lane);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) frag_b8(b[ni], b_s, nw + 8 * ni, kk, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if constexpr (T == 0) {
              mma_s8(acc[mi][ni], a[mi], b[ni]);
            } else {
              mma_u8(acc[mi][ni], a[mi], b[ni]);
            }
          }
      }
    }
  }

  Acc* Cp = reinterpret_cast<Acc*>(C);
  const int g = lane >> 2, t = lane & 3;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + mw + 16 * mi + g + 8 * (r >> 1);
        const int col = n0 + nw + 8 * ni + 2 * t + (r & 1);
        if (row < M && col < N) {
          Acc* p = Cp + (long long)row * ldc + col;
          if (split) {
            atomicAdd(p, acc[mi][ni][r]);
          } else {
            *p = acc[mi][ni][r];
          }
        }
      }
}

}  // namespace

// type: 0 s8, 1 u8, 2 bf16 of u8 values. ksplit: the number of K splits
// (C must be zero when it is above 1); kper, the K of each split, is a
// multiple of 64. Another type returns cudaErrorInvalidValue.
extern "C" int lf_int_gemm(const void* A, long long lda, const void* B, long long ldb, void* C,
                           long long ldc, int M, int N, int K, int type, int ksplit, int vec,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int kper = (K + ksplit - 1) / ksplit;
  kper = ((kper + TILE - 1) / TILE) * TILE;
  const int splits = (K + kper - 1) / kper;
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE, splits > 0 ? splits : 1);
  const unsigned char* a = (const unsigned char*)A;
  const unsigned char* b = (const unsigned char*)B;
#define LF_GEMM(TT)                                                                        \
  if (type == TT) {                                                                        \
    int_gemm_kernel<TT><<<grid, THREADS, 0, s>>>(a, lda, b, ldb, C, ldc, M, N, K, kper,   \
                                                 vec != 0);                                \
    return (int)cudaGetLastError();                                                        \
  }
  LF_GEMM(0)
  LF_GEMM(1)
  LF_GEMM(2)
#undef LF_GEMM
  return (int)cudaErrorInvalidValue;
}
