// CRT / ICRT of a batch of ring elements: a constant d x d matrix over F_q
// applied to every element's d-vector.
//
// Replaces: latticefold_tpu/rings/pallas_crt.py, `_fused_fn` (its `kernel`,
// launched through `crt` / `icrt` via `_apply`). That kernel reaches an exact
// mod-q product on a matrix unit without wide integer multiplies: it splits
// words into byte planes, runs one bf16 dot against a conv-folded,
// R*2^32-prescaled matrix and undoes it with a carry-pack and a wide REDC.
// Hopper multiplies 64-bit integers natively (__umul64hi), so none of that
// is carried over: each output coefficient is a 24-term dot product of u64
// values summed exactly in 192 bits and reduced once (field64.cuh).
//
// What bounds it: each element is d F_q values in and d out (8 B each:
// 192 + 192 bytes for Goldilocks; this kernel moves twice that, because the
// port keeps u32 limbs in int64 lanes) against d*d = 576 64-bit
// multiply-adds, about 1.5 per byte of the function's own; a 64x64 -> 128 product costs several
// 32-bit IMADs on this card, so integer throughput, not memory, is the
// likely limit.
// Design: one block stages EB elements with contiguous loads into shared
// memory (limb pairs fused into u64), keeps the matrix transposed in shared
// memory so a warp's threads read neighbouring words, and writes each
// output word once. No reduction crosses blocks.
//
// Input  x   : [N, d, 2] int64 (u32 limbs, Montgomery form)
// Matrix mat : [d(out), d(in), 2] int64 (Montgomery form)
// Output out : [N, d, 2] int64, out[n, o] = sum_i mat[o, i] x[n, i] R^-1 mod q

#include <cuda_runtime.h>

#include "field64.cuh"

namespace {

constexpr int EB = 64;        // elements per block
constexpr int THREADS = 256;  // threads per block

__global__ void crt_apply_kernel(const long long* __restrict__ x,
                                 const long long* __restrict__ mat,
                                 long long* __restrict__ out, int N, int d,
                                 Field64 f) {
  extern __shared__ u64 smem[];
  u64* mat_s = smem;          // [d(in)][d(out)]
  u64* x_s = smem + d * d;    // [EB][d]
  const int e0 = blockIdx.x * EB;
  const int ne = min(EB, N - e0);

  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int o = idx / d, i = idx % d;
    mat_s[i * d + o] = load_limbs(mat + 2 * (size_t)idx);
  }
  const long long* xb = x + 2 * (size_t)e0 * d;
  for (int idx = threadIdx.x; idx < ne * d; idx += blockDim.x) {
    x_s[idx] = load_limbs(xb + 2 * (size_t)idx);
  }
  __syncthreads();

  long long* ob = out + 2 * (size_t)e0 * d;
  for (int idx = threadIdx.x; idx < ne * d; idx += blockDim.x) {
    const int e = idx / d, o = idx % d;
    const u64* xe = x_s + e * d;
    Acc192 acc;
    acc_zero(acc);
    for (int i = 0; i < d; ++i) mac192(acc, xe[i], mat_s[i * d + o]);
    store_limbs(ob + 2 * (size_t)idx, redc192(acc, f));
  }
}

}  // namespace

extern "C" int lf_crt_apply(const void* x, const void* mat, void* out, int N,
                            int d, u64 q, u64 ninv, u64 r1, u64 r2,
                            void* stream) {
  if (N <= 0) return 0;
  Field64 f{q, ninv, r1, r2};
  const size_t smem = (size_t)(d * d + EB * d) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      crt_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + EB - 1) / EB;
  crt_apply_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)x, (const long long*)mat, (long long*)out, N, d, f);
  return (int)cudaGetLastError();
}
