// Kernel B: the epilogue of the byte-plane commit. From kernel A's signed
// plane products of every slice to the commitments,
//   [n_slices, c, Mpad, 4L] int32 -> [kappa, Nb, c, e, nl] Montgomery limbs,
// for the (limb width, extension degree) of every shipped ring: BabyBear
// (nl 1, e 9), Goldilocks (nl 2, e 3), Frog (nl 2, e 4) and Stark (nl 8,
// e 1), one template instance each.
//
// Replaces: latticefold_tpu/rings/pallas_commit.py `_epilogue_fused` with
// the slice corrections of `_commit_fused` before it and
// rings/mxu.py:_ext_fold after it.
//
// Per (component c, row block ke = k e + i, witness column o = j Nb + b):
// the unsigned plane product of rows i' (matrix limb byte) and columns j'
// (witness limb byte) is P + 128 colsum + 128 rowsum + 128^2 ks in each
// slice of ks terms (colsum is the all-ones row `rows` of P, rowsum the
// precomputed sM); they are summed by byte position s = i' + j' over the
// slices in u64, carried in base 256 into 2 nl + 1 limbs and reduced by
// R2 = 2^(32 (nl + 1)) (plane_epilogue.cuh), which gives the Montgomery
// product sum P_ij, canonical. Then the extension fold: out_t = conv_t +
// sum_k conv_(e+k) red[k][t], conv_s = sum_(i+j=s) P_ij, with the field's
// add and Montgomery mul (field32/64/256.cuh).
//
// What bounds it: it reads every plane product once (4 bytes each) and
// writes the commitments; its arithmetic is a few 32-bit multiply-adds per
// plane product: device memory bounds it.
// Design: a block owns one (k, c); its threads take the (b, i, j) items,
// keep an item's position sums in a local array, reduce it to P_ij in
// shared memory, then take the (b, t) outputs for the fold. Consecutive
// threads take consecutive b, whose columns are nl words apart.
//
// P   : [nsl, c, M, 4L] int32, sM: [c, nsl, M] int32, red: [e-1, e, nl]
//       int64 (Montgomery coordinates of y^(e+k) mod m(y)), out: [kappa,
//       Nb, c, e, nl] int64; all contiguous.

#include <cuda_runtime.h>

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"
#include "plane_epilogue.cuh"

namespace {

constexpr int MAX_THREADS = 256;

template <class F, int E>
__global__ void __launch_bounds__(MAX_THREADS)
    plane_epilogue_kernel(const int* __restrict__ P, const int* __restrict__ sM,
                          const long long* __restrict__ red, long long* __restrict__ out,
                          int nsl, int ncomp, int M, int L, int rows, int Nb, int n,
                          int kslice, F f, WideRedc<F::NL> wr) {
  typedef typename F::Elem Elem;
  constexpr int NL = F::NL;
  constexpr int DA = 4 * NL;
  constexpr int S = 2 * DA - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* pv = reinterpret_cast<Elem*>(smem_raw);  // [Nb][E][E]
  const int k = blockIdx.x, c = blockIdx.y;
  const long long N = 4LL * L;

  for (int item = threadIdx.x; item < Nb * E * E; item += blockDim.x) {
    const int b = item % Nb, j = (item / Nb) % E, i = item / (Nb * E);
    const int r0 = (k * E + i) * DA;
    const int o0 = (j * Nb + b) * NL;
    u64 u[S];
    for (int s = 0; s < S; ++s) u[s] = 0;
    for (int si = 0; si < nsl; ++si) {
      const long long ks = min(n, (si + 1) * kslice) - si * kslice;
      const int* Pc = P + ((long long)si * ncomp + c) * M * N;
      const int* sMc = sM + ((long long)c * nsl + si) * M;
      for (int jb = 0; jb < DA; ++jb) {
        const long long col = (long long)(jb & 3) * L + o0 + (jb >> 2);
        const long long base = 128LL * Pc[rows * N + col] + 16384LL * ks;
        for (int ia = 0; ia < DA; ++ia) {
          const int r = r0 + ia;
          u[ia + jb] += (u64)(Pc[r * N + col] + 128LL * sMc[r] + base);
        }
      }
    }
    u32 t[2 * NL + 2];
    carry_pack<NL>(u, S, t);
    u32 o[NL];
    wr.reduce(t, o);
    long long lanes[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) lanes[l] = o[l];
    pv[(b * E + i) * E + j] = F::load(lanes);
  }
  __syncthreads();

  for (int item = threadIdx.x; item < Nb * E; item += blockDim.x) {
    const int b = item / E, t = item % E;
    const Elem* p = pv + b * E * E;
    Elem conv[2 * E - 1];
    bool set[2 * E - 1];
#pragma unroll
    for (int s = 0; s < 2 * E - 1; ++s) set[s] = false;
#pragma unroll
    for (int i = 0; i < E; ++i)
#pragma unroll
      for (int j = 0; j < E; ++j) {
        conv[i + j] = set[i + j] ? f.add(conv[i + j], p[i * E + j]) : p[i * E + j];
        set[i + j] = true;
      }
    Elem o = conv[t];
#pragma unroll
    for (int kk = 0; kk < E - 1; ++kk) {
      o = f.add(o, f.mul(conv[E + kk], F::load(red + NL * (kk * E + t))));
    }
    F::store(out + NL * ((((long long)k * Nb + b) * ncomp + c) * E + t), o);
  }
}

template <class F, int E>
int launch(const void* P, const void* sM, const void* red, void* out, int nsl, int ncomp,
           int M, int L, int rows, int kappa, int Nb, int n, int kslice, const u64* consts,
           cudaStream_t stream) {
  const F f = F::from(consts);
  const WideRedc<F::NL> wr = WideRedc<F::NL>::from(consts);
  const size_t smem = (size_t)Nb * E * E * sizeof(typename F::Elem);
  cudaError_t err = cudaFuncSetAttribute(
      plane_epilogue_kernel<F, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((Nb * E * E + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  dim3 grid(kappa, ncomp);
  plane_epilogue_kernel<F, E><<<grid, threads, smem, stream>>>(
      (const int*)P, (const int*)sM, (const long long*)red, (long long*)out, nsl, ncomp, M,
      L, rows, Nb, n, kslice, f, wr);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: the field's u64 words (latticefold_torch/cuda.py:field_constants).
// (nl, e) must be one of the instances below: any other returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int lf_plane_epilogue(const void* P, const void* sM, const void* red, void* out,
                                 int nsl, int ncomp, int M, int L, int rows, int kappa,
                                 int Nb, int e, int nl, int n, int kslice, const u64* consts,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LF_EPILOGUE(FT, EE)                                                          \
  if (nl == FT::NL && e == EE)                                                       \
    return launch<FT, EE>(P, sM, red, out, nsl, ncomp, M, L, rows, kappa, Nb, n, kslice, \
                          consts, s);
  LF_EPILOGUE(F32, 9)
  LF_EPILOGUE(F64, 3)
  LF_EPILOGUE(F64, 4)
  LF_EPILOGUE(F256, 1)
#undef LF_EPILOGUE
  return (int)cudaErrorInvalidValue;
}
