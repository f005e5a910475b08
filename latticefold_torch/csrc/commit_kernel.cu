// Ajtai commitment of a witness batch:
//   cm[k, b, c] = sum_n A[k, n, c] *_K f[n, b, c]   in K = F_q[y]/m(y).
//
// Replaces: latticefold_tpu/rings/pallas_commit.py, `_fused_slice` (kernel
// `_dot_kernel`) and `_epilogue_fused`, together with the extension fold
// `rings/mxu.py:_ext_fold` that runs after them. On the TPU the contraction
// is split into signed-i8 byte-plane dots with rank-1 corrections, slices
// of at most 2^15 terms, a (lo16, hi16) carry epilogue and a wide REDC,
// because its matrix unit has no exact wide-integer multiply. Hopper
// multiplies 64-bit integers natively, so this kernel sums the exact
// 128-bit products of the Montgomery-form coordinates in 192-bit registers
// and reduces once (field64.cuh); the result is the same canonical limbs.
//
// What bounds it: at the fold's shapes (kappa = 9, n = 20480, e = 3) the
// function reads (kappa + Nb) n ncomp e F_q elements of 8 B; this kernel
// reads twice that, because the port keeps u32 limbs in int64 lanes. The
// work is kappa Nb ncomp n e^2 64-bit multiply-adds; at Nb = 14 that is
// about two multiply-adds per byte of the function's own, and a 64x64 -> 128 product costs
// several 32-bit IMADs on this card, so integer throughput, not memory,
// is the likely limit.
// Design: pass 1 gives each block one CRT component and one chunk of n; its
// threads own (k, b) output pairs and keep the 2e-1 convolution
// coefficients of their pair in 192-bit accumulators while tiles of A and f
// pass through shared memory (a tile row of A serves every b, a row of f
// every k). Blocks run in no order, so no sum is carried between them:
// pass 1 writes one 192-bit partial per (chunk, component, pair,
// coefficient) and pass 2 adds the partials, reduces each coefficient mod q
// and folds y^(e+k) back with the reduction rows of m(y).
//
// A       : [kappa, n, ncomp, e, 2] int64 (u32 limbs, Montgomery form)
// f       : [n, Nb, ncomp, e, 2] int64
// red     : [e-1, e, 2] int64, Montgomery coordinates of y^(e+k) mod m(y)
// partial : [nchunks, ncomp, kappa*Nb, 2e-1, 3] u64 scratch
// out     : [kappa, Nb, ncomp, e, 2] int64

#include <cuda_runtime.h>

#include "field64.cuh"

namespace {

template <int E>
__global__ void commit_partial_kernel(const long long* __restrict__ A,
                                      const long long* __restrict__ F,
                                      u64* __restrict__ partial, int kappa,
                                      int n, int Nb, int ncomp, int chunk,
                                      int TN) {
  constexpr int S = 2 * E - 1;
  extern __shared__ u64 smem[];
  u64* a_s = smem;                    // [kappa][TN][E]
  u64* f_s = smem + kappa * TN * E;   // [TN][Nb][E]
  const int c = blockIdx.x;
  const int ch = blockIdx.y;
  const int n0 = ch * chunk;
  const int n1 = min(n, n0 + chunk);
  const int P = kappa * Nb;

  for (int p0 = 0; p0 < P; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < P;
    const int k = active ? p / Nb : 0;
    const int b = active ? p % Nb : 0;
    Acc192 acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc_zero(acc[s]);

    for (int nt = n0; nt < n1; nt += TN) {
      const int tn = min(TN, n1 - nt);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kappa * tn * E; idx += blockDim.x) {
        const int kk = idx / (tn * E), r = idx % (tn * E);
        const int j = r / E, t = r % E;
        const size_t src = (((size_t)kk * n + nt + j) * ncomp + c) * E + t;
        a_s[(kk * TN + j) * E + t] = load_limbs(A + 2 * src);
      }
      for (int idx = threadIdx.x; idx < tn * Nb * E; idx += blockDim.x) {
        const int j = idx / (Nb * E), r = idx % (Nb * E);
        const int bb = r / E, t = r % E;
        const size_t src = (((size_t)(nt + j) * Nb + bb) * ncomp + c) * E + t;
        f_s[(j * Nb + bb) * E + t] = load_limbs(F + 2 * src);
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < tn; ++j) {
          const u64* a = a_s + (k * TN + j) * E;
          const u64* w = f_s + (j * Nb + b) * E;
          u64 wv[E];
#pragma unroll
          for (int t = 0; t < E; ++t) wv[t] = w[t];
#pragma unroll
          for (int i = 0; i < E; ++i) {
            const u64 ai = a[i];
#pragma unroll
            for (int t = 0; t < E; ++t) mac192(acc[i + t], ai, wv[t]);
          }
        }
      }
    }
    if (active) {
      u64* dst = partial + (((size_t)ch * ncomp + c) * P + p) * S * 3;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        dst[3 * s] = acc[s].w0;
        dst[3 * s + 1] = acc[s].w1;
        dst[3 * s + 2] = acc[s].w2;
      }
    }
  }
}

template <int E>
__global__ void commit_final_kernel(const u64* __restrict__ partial,
                                    const long long* __restrict__ red,
                                    long long* __restrict__ out, int nchunks,
                                    int ncomp, int kappa, int Nb, Field64 f) {
  constexpr int S = 2 * E - 1;
  const int P = kappa * Nb;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= ncomp * P) return;
  const int c = gid / P, p = gid % P;
  const int k = p / Nb, b = p % Nb;

  u64 v[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    Acc192 acc;
    acc_zero(acc);
    for (int ch = 0; ch < nchunks; ++ch) {
      const u64* src = partial + ((((size_t)ch * ncomp + c) * P + p) * S + s) * 3;
      Acc192 part{src[0], src[1], src[2]};
      add192(acc, part);
    }
    v[s] = redc192(acc, f);
  }
  long long* dst = out + (((size_t)k * Nb + b) * ncomp + c) * E * 2;
#pragma unroll
  for (int t = 0; t < E; ++t) {
    u64 o = v[t];
#pragma unroll
    for (int kk = 0; kk < E - 1; ++kk) {
      const u64 row = load_limbs(red + 2 * (kk * E + t));
      o = add_mod(o, mont_mul64(v[E + kk], row, f), f.q);
    }
    store_limbs(dst + 2 * t, o);
  }
}

template <int E>
int launch(const void* A, const void* F, const void* red, void* partial,
           void* out, int kappa, int n, int Nb, int ncomp, int nchunks,
           int chunk, int TN, const Field64& f, cudaStream_t stream) {
  const size_t smem = (size_t)TN * E * (kappa + Nb) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      commit_partial_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int P = kappa * Nb;
  int threads = ((P + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dim3 grid(ncomp, nchunks);
  commit_partial_kernel<E><<<grid, threads, smem, stream>>>(
      (const long long*)A, (const long long*)F, (u64*)partial, kappa, n, Nb,
      ncomp, chunk, TN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = ncomp * P;
  commit_final_kernel<E><<<(total + 127) / 128, 128, 0, stream>>>(
      (const u64*)partial, (const long long*)red, (long long*)out, nchunks,
      ncomp, kappa, Nb, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lf_ajtai_commit(const void* A, const void* F, const void* red,
                               void* partial, void* out, int kappa, int n,
                               int Nb, int ncomp, int e, int nchunks, int chunk,
                               int TN, u64 q, u64 ninv, u64 r1, u64 r2,
                               void* stream) {
  Field64 f{q, ninv, r1, r2};
  cudaStream_t s = (cudaStream_t)stream;
  switch (e) {
    case 1:
      return launch<1>(A, F, red, partial, out, kappa, n, Nb, ncomp, nchunks, chunk, TN, f, s);
    case 2:
      return launch<2>(A, F, red, partial, out, kappa, n, Nb, ncomp, nchunks, chunk, TN, f, s);
    case 3:
      return launch<3>(A, F, red, partial, out, kappa, n, Nb, ncomp, nchunks, chunk, TN, f, s);
    case 4:
      return launch<4>(A, F, red, partial, out, kappa, n, Nb, ncomp, nchunks, chunk, TN, f, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
