// Kernel C's bf16 instance on Hopper: C = A B with A [M, K] and B [K, N]
// uint8 (row-major), the values taken as bf16, float32 sums, float32 C
// [M, N] (contiguous). The sums equal the exact integer sums rounded once
// to float32 (plane_probes.bf16_gemm_plain), bit for bit, for K <= 258.
//
// Replaces: the TPU probe benches/exp_pallas_probe.py `k_dot_bf` (:70-88,
// `dot_u8_via_bf16`, 128 x 128 x 128): u8 operands cast to bf16 inside the
// kernel, a dot with float32 accumulation. Its first design is
// int_gemm_kernel.cu's type 2 (mma.sync, 64 x 64 tiles, two 64-deep passes
// a block), now the in-call baseline.
//
// What bounds it: 2 M N K operations on M K + K N + 4 M N bytes, at
// 128 x 128 x 128 0.0042 us of bf16 tensor cores and 0.029 us of HBM: far
// below the launch (about 5 us). It is latency-bound: the launch, one round
// trip to memory for the operands, the MMAs, the stores.
//
// What the design does about it (bf16_gemm_sm90.cuh has the block
// algorithm): one launch (no split K, no memset of C); 64 x 32 output tiles
// (8 blocks at 128 x 128, which the card ran faster than 16 blocks of
// 64 x 16 and 4 of 64 x 64), so each block's loads are small; every load
// of a block's whole K slab issued before any wait, 16 bytes a load; no
// byte transpose: the logical k order of the MMA is a permutation of the
// physical one, chosen so that the bytes a thread loads of A are its wgmma
// register fragment (converted to bf16 once), and B's k-rows go to shared
// memory as bf16, MN-major, which the 16-bit wgmma reads through its
// transpose bit; float32 sums in the wgmma accumulators; C written with
// 16-byte stores after one shuffle between neighbouring lanes.

#include <cuda_runtime.h>

#include "bf16_gemm_sm90.cuh"
#include "sm90_async.cuh"

namespace {

using namespace bf16g;

// wgmma.mma_async m64n32k16, f32 += bf16 x bf16, A from registers, B from
// shared memory MN-major (imm-trans-b 1), D += A B
__device__ __forceinline__ void wgmma_bf16(float (&d)[NACC], const u32 (&a)[4], u64 desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the no-swizzle shared-memory descriptor (layout type 0) of an MN-major
// operand: start, leading byte offset (k direction), stride byte offset
// (n direction)
__device__ __forceinline__ u64 desc_mn(u32 addr, u32 lbo, u32 sbo) {
  return (u64)((addr & 0x3FFFF) >> 4) | ((u64)(lbo >> 4) << 16) | ((u64)(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int SS>
__global__ void __launch_bounds__(THREADS)
    bf16_gemm_sm90(const unsigned char* __restrict__ A, long long lda, const unsigned char* __restrict__ B,
                   long long ldb, float* __restrict__ C, int M, int N, int K, bool vec_a, bool vec_b,
                   bool vec_c) {
  // SS KS k-rows of BN bf16, MN-major cores
  __shared__ __align__(128) unsigned short b_s[SS * KS * BN];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int r0 = m0 + 16 * warp + (lane >> 2);

  // every load of the block's slab, before any use
  Chunk a_raw[SS][2][2], b_raw[SS][BN / 16];
#pragma unroll
  for (int c = 0; c < SS; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        a_raw[c][h][q] = load_chunk(A, lda, r0 + 8 * h, M, KS * c + 32 * (lane & 3) + 16 * q, K, vec_a);
#pragma unroll
    for (int q = 0; q < BN / 16; ++q) b_raw[c][q] = load_chunk(B, ldb, KS * c + tid, K, n0 + 16 * q, N, vec_b);
  }

  // B's k-rows as bf16 at their logical k
#pragma unroll
  for (int c = 0; c < SS; ++c) {
    const int k = KS * c + k_logical(tid);
#pragma unroll
    for (int q = 0; q < BN / 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const u32 w0 = b_raw[c][q].w[2 * e], w1 = b_raw[c][q].w[2 * e + 1];
        const uint4 v = make_uint4(bf16x2(w0, 0), bf16x2(w0, 2), bf16x2(w1, 0), bf16x2(w1, 2));
        *reinterpret_cast<uint4*>(b_s + b_index(k, 16 * q + 8 * e)) = v;
      }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  u32 a[SS][8][4];
#pragma unroll
  for (int c = 0; c < SS; ++c)
#pragma unroll
    for (int s = 0; s < 8; ++s) a_frag(a[c][s], a_raw[c][0][s >> 2].w[s & 3], a_raw[c][1][s >> 2].w[s & 3]);
  __syncthreads();
  float out[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) out[j] = 0.0f;
  const u32 base = sm90::smem_u32(b_s);
  fence_acc(out);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int c = 0; c < SS; ++c)
#pragma unroll
    for (int s = 0; s < 8; ++s) wgmma_bf16(out, a[c][s], desc_mn(base + (8 * c + s) * DESC_STEP, DESC_LBO, DESC_SBO));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(out);

  // trade pairs with lane ^ 1, then one 16-byte store of four columns
  const bool odd = lane & 1;
  const int row = m0 + out_row(warp, lane);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const float v[4] = {out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]};
    float x0, x1, o[4];
    quad_send(v, odd, x0, x1);
    const float y0 = __shfl_xor_sync(0xFFFFFFFFu, x0, 1), y1 = __shfl_xor_sync(0xFFFFFFFFu, x1, 1);
    quad_out(v, odd, y0, y1, o);
    const int col = n0 + out_col(i, lane);
    if (row < M) {
      float* p = C + (long long)row * N + col;
      if (vec_c && col + 4 <= N) {
        *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) p[e] = o[e];
      }
    }
  }
}

}  // namespace

// A's and B's rows may lie at any stride (lda >= K, ldb >= N, in bytes);
// 16-byte loads where the pointer and stride are multiples of 16. C: [M, N]
// float32, contiguous. An empty shape or K > K_EXACT returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int lf_bf16_gemm_sm90(const void* A, long long lda, const void* B, long long ldb, void* C, int M,
                                 int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > K_EXACT || lda < K || ldb < N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* a = (const unsigned char*)A;
  const unsigned char* b = (const unsigned char*)B;
  float* c = (float*)C;
  const bool va = (unsigned long long)A % 16 == 0 && lda % 16 == 0;
  const bool vb = (unsigned long long)B % 16 == 0 && ldb % 16 == 0;
  const bool vc = (unsigned long long)C % 16 == 0 && N % 4 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int ss = (K + KS - 1) / KS;
  if (ss == 1) bf16_gemm_sm90<1><<<grid, THREADS, 0, s>>>(a, lda, b, ldb, c, M, N, K, va, vb, vc);
  if (ss == 2) bf16_gemm_sm90<2><<<grid, THREADS, 0, s>>>(a, lda, b, ldb, c, M, N, K, va, vb, vc);
  if (ss == 3) bf16_gemm_sm90<3><<<grid, THREADS, 0, s>>>(a, lda, b, ldb, c, M, N, K, va, vb, vc);
  return (int)cudaGetLastError();
}
