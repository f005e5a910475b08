// CRT / ICRT of a batch of ring elements: a constant d x d matrix over F_q
// applied to every element's d-vector, for every limb width the rings use
// (nl = 1, 2, 8: one template instance per field type).
//
// Replaces: latticefold_tpu/rings/pallas_crt.py, `_fused_fn` (its `kernel`,
// launched through `crt` / `icrt` via `_apply`). That kernel reaches an exact
// mod-q product on a matrix unit without wide integer multiplies: it splits
// words into byte planes, runs one bf16 dot against a conv-folded,
// R*2^32-prescaled matrix and undoes it with a carry-pack and a wide REDC.
// Hopper multiplies 64-bit integers natively, so none of that is carried
// over: each output coefficient is a d-term dot product summed exactly in a
// lazy accumulator and reduced once (field32/64/256.cuh).
//
// What bounds it, per element (d F_q values in, d out; 4 nl bytes each):
//   BabyBear  d 72, 4 B:  576 B against 5184 products of 32-bit values
//                         (one 32x32 -> 64 multiply each);
//   Goldilocks d 24, 8 B: 384 B against 576 64x64 products (4 each);
//   Stark     d 16, 32 B: 1024 B against 256 256x256 products (64 each).
// That is 9, 6 and 16 32-bit multiplies per byte of the function's own, far
// above what the card's integer units can do per byte of memory bandwidth,
// so integer multiplies, not memory, are the limit at every width; this
// kernel also moves twice the bytes, because the port keeps u32 limbs in
// int64 lanes.
// Design: one block stages EB elements with contiguous loads into shared
// memory (limbs fused into the field's words), keeps the matrix transposed
// in shared memory (20 KB for BabyBear's 72 x 72 as u32, 8 KB for Stark's
// 16 x 16 as 32-byte values) so a warp's threads read neighbouring words,
// and writes each output value once. No reduction crosses blocks.
//
// Input  x   : [N, d, nl] int64 (u32 limbs, Montgomery form)
// Matrix mat : [d(out), d(in), nl] int64 (Montgomery form)
// Output out : [N, d, nl] int64, out[n, o] = sum_i mat[o, i] x[n, i] R^-1 mod q

#include <cuda_runtime.h>

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"

namespace {

constexpr int EB = 64;        // elements per block
constexpr int THREADS = 256;  // threads per block

template <class F>
__global__ void __launch_bounds__(THREADS)
    crt_apply_kernel(const long long* __restrict__ x,
                     const long long* __restrict__ mat,
                     long long* __restrict__ out, int N, int d, F f) {
  typedef typename F::Elem Elem;
  constexpr int NL = F::NL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* mat_s = reinterpret_cast<Elem*>(smem_raw);  // [d(in)][d(out)]
  Elem* x_s = mat_s + d * d;                         // [EB][d]
  const int e0 = blockIdx.x * EB;
  const int ne = min(EB, N - e0);

  for (int idx = threadIdx.x; idx < d * d; idx += blockDim.x) {
    const int o = idx / d, i = idx % d;
    mat_s[i * d + o] = F::load(mat + NL * (size_t)idx);
  }
  const long long* xb = x + NL * (size_t)e0 * d;
  for (int idx = threadIdx.x; idx < ne * d; idx += blockDim.x) {
    x_s[idx] = F::load(xb + NL * (size_t)idx);
  }
  __syncthreads();

  long long* ob = out + NL * (size_t)e0 * d;
  for (int idx = threadIdx.x; idx < ne * d; idx += blockDim.x) {
    const int e = idx / d, o = idx % d;
    const Elem* xe = x_s + e * d;
    typename F::Acc acc;
    F::zero(acc);
    for (int i = 0; i < d; ++i) F::mac(acc, xe[i], mat_s[i * d + o]);
    F::store(ob + NL * (size_t)idx, f.reduce(acc));
  }
}

template <class F>
int launch(const void* x, const void* mat, void* out, int N, int d,
           const u64* consts, cudaStream_t stream) {
  const size_t smem = (size_t)(d * d + EB * d) * sizeof(typename F::Elem);
  cudaError_t err = cudaFuncSetAttribute(
      crt_apply_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + EB - 1) / EB;
  crt_apply_kernel<F><<<blocks, THREADS, smem, stream>>>(
      (const long long*)x, (const long long*)mat, (long long*)out, N, d,
      F::from(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// consts: the field's u64 words (latticefold_torch/cuda.py:field_constants)
extern "C" int lf_crt_apply(const void* x, const void* mat, void* out, int N,
                            int d, int nl, const u64* consts, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 1:
      return launch<F32>(x, mat, out, N, d, consts, s);
    case 2:
      return launch<F64>(x, mat, out, N, d, consts, s);
    case 8:
      return launch<F256>(x, mat, out, N, d, consts, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
