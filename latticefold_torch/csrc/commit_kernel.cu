// Ajtai commitment of a witness batch:
//   cm[k, b, c] = sum_n A[k, n, c] *_K f[n, b, c]   in K = F_q[y]/m(y),
// for the (limb width, extension degree) of every shipped ring: BabyBear
// (nl 1, e 9), Goldilocks (nl 2, e 3), Frog (nl 2, e 4) and Stark (nl 8,
// e 1), one template instance each.
//
// Replaces: latticefold_tpu/rings/pallas_commit.py, `_fused_slice` (kernel
// `_dot_kernel`) and `_epilogue_fused`, together with the extension fold
// `rings/mxu.py:_ext_fold` that runs after them. On the TPU the contraction
// is split into signed-i8 byte-plane dots with rank-1 corrections, slices
// of at most 2^15 terms, a (lo16, hi16) carry epilogue and a wide REDC,
// because its matrix unit has no exact wide-integer multiply. Hopper
// multiplies 64-bit integers natively, so this kernel sums the exact
// products of the Montgomery-form coordinates in lazy accumulators and
// reduces once (field32/64/256.cuh); the result is the same canonical limbs.
//
// What bounds it: the function reads (kappa + Nb) n ncomp e F_q values of
// 4 nl bytes and does kappa Nb ncomp n e^2 F_q products; a product of
// nl-limb values is nl^2 32x32 -> 64 multiplies. Per byte of the function's
// own that is about 2 (BabyBear, kappa 6, Nb 7, n 16384), 4 (Goldilocks,
// kappa 9, Nb 14) and 11 (Stark, kappa 17, Nb 31, n 32768) such multiplies,
// so integer multiply throughput, not memory, is the limit; this kernel
// also reads twice the bytes, because the port keeps u32 limbs in int64
// lanes. At Stark's shapes the per-thread accumulator is nine u64 words and
// a block's 527 (k, b) pairs are taken 256 at a time.
// Design: pass 1 gives each block one CRT component and one chunk of n; its
// threads own (k, b) output pairs and keep the 2e-1 convolution
// coefficients of their pair in lazy accumulators while tiles of A and f
// pass through shared memory (a tile row of A serves every b, a row of f
// every k; elements are 4 nl bytes there). Blocks run in no order, so no
// sum is carried between them: pass 1 reduces each accumulator to one
// canonical value per (chunk, component, pair, coefficient), and pass 2
// adds the chunks' values mod q and folds y^(e+k) back with the reduction
// rows of m(y). Reducing per chunk gives the same residue as one reduction
// of the whole sum: both are (sum of products) R^-1 mod q.
//
// A       : [kappa, n, ncomp, e, nl] int64 (u32 limbs, Montgomery form)
// f       : [n, Nb, ncomp, e, nl] int64
// red     : [e-1, e, nl] int64, Montgomery coordinates of y^(e+k) mod m(y)
// partial : [nchunks, ncomp, kappa*Nb, 2e-1, nl] int64 scratch
// out     : [kappa, Nb, ncomp, e, nl] int64

#include <cuda_runtime.h>

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"

namespace {

constexpr int PASS1_THREADS = 256;  // most threads of a pass-1 block

template <class F, int E>
__global__ void __launch_bounds__(PASS1_THREADS)
    commit_partial_kernel(const long long* __restrict__ A,
                          const long long* __restrict__ Fw,
                          long long* __restrict__ partial, int kappa, int n,
                          int Nb, int ncomp, int chunk, int TN, F f) {
  typedef typename F::Elem Elem;
  constexpr int NL = F::NL;
  constexpr int S = 2 * E - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* a_s = reinterpret_cast<Elem*>(smem_raw);  // [kappa][TN][E]
  Elem* f_s = a_s + kappa * TN * E;                // [TN][Nb][E]
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
    typename F::Acc acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) F::zero(acc[s]);

    for (int nt = n0; nt < n1; nt += TN) {
      const int tn = min(TN, n1 - nt);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kappa * tn * E; idx += blockDim.x) {
        const int kk = idx / (tn * E), r = idx % (tn * E);
        const int j = r / E, t = r % E;
        const size_t src = (((size_t)kk * n + nt + j) * ncomp + c) * E + t;
        a_s[(kk * TN + j) * E + t] = F::load(A + NL * src);
      }
      for (int idx = threadIdx.x; idx < tn * Nb * E; idx += blockDim.x) {
        const int j = idx / (Nb * E), r = idx % (Nb * E);
        const int bb = r / E, t = r % E;
        const size_t src = (((size_t)(nt + j) * Nb + bb) * ncomp + c) * E + t;
        f_s[(j * Nb + bb) * E + t] = F::load(Fw + NL * src);
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < tn; ++j) {
          const Elem* a = a_s + (k * TN + j) * E;
          const Elem* w = f_s + (j * Nb + b) * E;
          Elem wv[E];
#pragma unroll
          for (int t = 0; t < E; ++t) wv[t] = w[t];
#pragma unroll
          for (int i = 0; i < E; ++i) {
            const Elem ai = a[i];
#pragma unroll
            for (int t = 0; t < E; ++t) F::mac(acc[i + t], ai, wv[t]);
          }
        }
      }
    }
    if (active) {
      long long* dst = partial + NL * ((((size_t)ch * ncomp + c) * P + p) * S);
#pragma unroll
      for (int s = 0; s < S; ++s) F::store(dst + NL * s, f.reduce(acc[s]));
    }
  }
}

template <class F, int E>
__global__ void commit_final_kernel(const long long* __restrict__ partial,
                                    const long long* __restrict__ red,
                                    long long* __restrict__ out, int nchunks,
                                    int ncomp, int kappa, int Nb, F f) {
  typedef typename F::Elem Elem;
  constexpr int NL = F::NL;
  constexpr int S = 2 * E - 1;
  const int P = kappa * Nb;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= ncomp * P) return;
  const int c = gid / P, p = gid % P;
  const int k = p / Nb, b = p % Nb;

  Elem v[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long* src = partial + NL * (((size_t)c * P + p) * S + s);
    Elem sum = F::load(src);
    for (int ch = 1; ch < nchunks; ++ch) {
      sum = f.add(sum, F::load(src + NL * ((size_t)ch * ncomp * P * S)));
    }
    v[s] = sum;
  }
  long long* dst = out + NL * ((((size_t)k * Nb + b) * ncomp + c) * E);
#pragma unroll
  for (int t = 0; t < E; ++t) {
    Elem o = v[t];
#pragma unroll
    for (int kk = 0; kk < E - 1; ++kk) {
      o = f.add(o, f.mul(v[E + kk], F::load(red + NL * (kk * E + t))));
    }
    F::store(dst + NL * t, o);
  }
}

template <class F, int E>
int launch(const void* A, const void* Fw, const void* red, void* partial,
           void* out, int kappa, int n, int Nb, int ncomp, int nchunks,
           int chunk, int TN, const u64* consts, cudaStream_t stream) {
  const F f = F::from(consts);
  const size_t smem =
      (size_t)TN * E * (kappa + Nb) * sizeof(typename F::Elem);
  cudaError_t err = cudaFuncSetAttribute(
      commit_partial_kernel<F, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int P = kappa * Nb;
  int threads = ((P + 31) / 32) * 32;
  if (threads > PASS1_THREADS) threads = PASS1_THREADS;
  dim3 grid(ncomp, nchunks);
  commit_partial_kernel<F, E><<<grid, threads, smem, stream>>>(
      (const long long*)A, (const long long*)Fw, (long long*)partial, kappa,
      n, Nb, ncomp, chunk, TN, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = ncomp * P;
  commit_final_kernel<F, E><<<(total + 127) / 128, 128, 0, stream>>>(
      (const long long*)partial, (const long long*)red, (long long*)out,
      nchunks, ncomp, kappa, Nb, f);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: the field's u64 words (latticefold_torch/cuda.py:field_constants).
// (nl, e) must be one of the instances below: any other returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int lf_ajtai_commit(const void* A, const void* Fw, const void* red,
                               void* partial, void* out, int kappa, int n,
                               int Nb, int ncomp, int e, int nl, int nchunks,
                               int chunk, int TN, const u64* consts,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LF_COMMIT(FT, EE)                                                   \
  if (nl == FT::NL && e == EE)                                              \
    return launch<FT, EE>(A, Fw, red, partial, out, kappa, n, Nb, ncomp,    \
                          nchunks, chunk, TN, consts, s);
  LF_COMMIT(F32, 9)
  LF_COMMIT(F64, 3)
  LF_COMMIT(F64, 4)
  LF_COMMIT(F256, 1)
#undef LF_COMMIT
  return (int)cudaErrorInvalidValue;
}
