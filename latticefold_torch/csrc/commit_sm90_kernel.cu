// The Ajtai commitment of a witness batch, rebuilt for Hopper:
//   cm[k, b, c] = sum_n A[k, n, c] *_K f[n, b, c]   in K = F_q[y]/m(y),
// for BabyBear (nl 1, e 9), Goldilocks (nl 2, e 3), Frog (nl 2, e 4) and
// Stark (nl 8, e 1); the same limbs as commit_kernel.cu, which stays as its
// in-call baseline.
//
// Replaces: latticefold_tpu/rings/pallas_commit.py, `_fused_slice` (kernel
// `_dot_kernel`) and `_epilogue_fused`, with rings/mxu.py:_ext_fold after
// them, as commit_kernel.cu did: the function of K2 + K3 as one mod-q
// product (Hopper multiplies 64-bit integers natively, so no byte planes).
//
// What bounds it: at LatticeFold+'s kappa <= 2 the bytes of f and A (about
// one F_q product a byte: a matrix-vector product, which int8 tensor cores
// do not help; its tensor-core form is the byte-plane route of
// plane_commit.py); at the folds' P = kappa Nb of 42-576 the 32-bit
// multiply-adds of the e^2 nl^2 limb products of each (k, b, c, n).
//
// What commit_kernel.cu did wrong, and what this design does about it
// (commit_sm90.cuh, whose phases the CPU test runs):
//  1. Its pass 2 gave a thread to each (component, pair) and added all the
//     chunks' partials serially. Here pass 2 gives each (c, p) up to 8
//     warps, one thread a chunk or two: they add the chunks as wide
//     integers in parallel, shuffle trees add them, and each coefficient is
//     reduced once, by its own lane.
//  2. Its pass-1 block was P threads rounded up to a warp (2 busy of 32 at
//     P = 2). Here a thread is a lane of an item (component, tile of pairs):
//     the L lanes of an item take rows j = lane, lane + L, ... and add
//     their sums at the end, so every warp works at P = 2.
//  3. Its blocks each read one component's slice of every row. Here a
//     block owns a chunk of n for every component and stages whole rows of
//     A and f with 16-byte copies.
//  4. Its loads did not overlap its products. Here stage t + 1 is copied
//     with cp.async into the other of two buffers while stage t is
//     multiplied; where one tile spans k (LatticeFold+), each f value has
//     one reader, which loads it from device memory rows ahead.
//  5. At Stark's P = 527 it staged every tile three times, 256 pairs at a
//     time. Here a thread owns a register tile of KT x BT pairs and a block
//     a group of tiles, so each block stages its rows once; at large P the
//     groups split the pairs, and the re-reads of A and f go to L2.
// No tensor cores: see the bound above.
//
// Two launches a call: pass 1 (grid groups x chunks) and pass 2 (fwarps
// warps per output). `mode` runs one pass alone, to time them apart (bit 0: pass 1,
// bit 1: pass 2).
//
// A, f : int64 lanes, contiguous, 16-byte aligned; partial: u64 scratch
// [nchunks, ncomp, kappa Nb, 2e - 1, W]; red: [e - 1, e, nl] int64; out:
// [kappa, Nb, ncomp, e, nl] int64.

#include <cuda_runtime.h>

#include "commit_sm90.cuh"

namespace {

template <class Acc>
__device__ __forceinline__ void shfl_add(Acc& a, int o) {
  constexpr int W = sizeof(Acc) / 8;
  Acc x;
  u64* xw = reinterpret_cast<u64*>(&x);
  const u64* aw = reinterpret_cast<const u64*>(&a);
#pragma unroll
  for (int w = 0; w < W; ++w) xw[w] = __shfl_xor_sync(0xffffffffu, aw[w], o);
  cm90::acc_add(a, x);
}

template <class Elem>
__device__ __forceinline__ Elem shfl_elem(const Elem& v, int src) {
  constexpr int W = sizeof(Elem) / sizeof(u32);
  Elem x;
  u32* xw = reinterpret_cast<u32*>(&x);
  const u32* vw = reinterpret_cast<const u32*>(&v);
#pragma unroll
  for (int w = 0; w < W; ++w) xw[w] = __shfl_sync(0xffffffffu, vw[w], src);
  return x;
}

template <class F, int E, int KT, int BT, bool DF>
__global__ void __launch_bounds__(cm90::max_threads(F::NL, E, KT, BT, DF))
    commit_sm90_partial(const cm90::Problem pr) {
  typedef cm90::Block<F, E, KT, BT, DF> B;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const B blk(pr, blockIdx.x, blockIdx.y, smem_raw);
  const int tid = threadIdx.x, nth = blockDim.x;
  typename B::Regs r;
  B::zero(r);
  const int ns = blk.stages();
  if (ns > 0) blk.stage(0, 0, tid, nth);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int t = 0; t < ns; ++t) {
    // stage t + 1 into the buffer that stage t - 1 left at the barrier
    // ending t - 1; a group a step (empty after the last stage), so that
    // waiting for all but the newest group waits for stage t
    if (t + 1 < ns) blk.stage((t + 1) & 1, t + 1, tid, nth);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    blk.mac_rows(t & 1, t, tid, r);
    __syncthreads();
  }
  typename B::Sums sums;
  B::sums(r, sums);
  for (int o = pr.lanes / 2; o >= 1; o >>= 1)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
#pragma unroll
        for (int s = 0; s < B::S; ++s) shfl_add(sums.acc[kk][bb][s], o);
  blk.write_partial(tid, sums);
}

template <class F, int E>
__global__ void __launch_bounds__(cm90::FINISH_THREADS) commit_sm90_finish(const cm90::Problem pr, F f) {
  typedef cm90::Finish<F, E> Fin;
  typedef typename F::Elem Elem;
  typedef typename F::Acc Acc;
  constexpr int S = Fin::S, WARPS = cm90::FINISH_THREADS / cm90::WARP;
  __shared__ Acc warp_sums[WARPS][S];
  const Fin fin{pr};
  const int tid = threadIdx.x, lane = tid % cm90::WARP, warp = tid / cm90::WARP, fw = pr.fwarps;
  int c, p, sub;
  const bool live = Fin::coords(pr, blockIdx.x, warp, c, p, sub);
  Acc acc[S];
  if (live)
    fin.chunk_sum(c, p, sub * cm90::WARP + lane, fw * cm90::WARP, acc);
  else
#pragma unroll
    for (int s = 0; s < S; ++s) F::zero(acc[s]);
#pragma unroll
  for (int o = cm90::WARP / 2; o >= 1; o >>= 1)
#pragma unroll
    for (int s = 0; s < S; ++s) shfl_add(acc[s], o);
  if (fw > 1) {  // the output's warps through shared memory to its first
    if (lane == 0)
#pragma unroll
      for (int s = 0; s < S; ++s) warp_sums[warp][s] = acc[s];
    __syncthreads();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (sub == 0 && lane < fw)
        acc[s] = warp_sums[warp + lane][s];
      else
        F::zero(acc[s]);
    }
#pragma unroll
    for (int o = cm90::WARP / 2; o >= 1; o >>= 1)
#pragma unroll
      for (int s = 0; s < S; ++s) shfl_add(acc[s], o);
  }
  if (!live || sub != 0) return;
  // lane s reduces coefficient s (a select, then one reduce in step)
  Acc mine = acc[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (lane == s) mine = acc[s];
  const Elem v = f.reduce(mine);
  Elem vs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) vs[s] = shfl_elem(v, s);
  if (lane >= E) return;
  Elem o = vs[0];
#pragma unroll
  for (int s = 1; s < E; ++s)
    if (lane == s) o = vs[s];
  fin.store(c, p, lane, fin.fold(f, o, vs, lane));
}

template <class F, int E, int KT, int BT, bool DF>
int launch(const cm90::Problem& pr, int mode, const u64* consts, cudaStream_t stream) {
  typedef cm90::Block<F, E, KT, BT, DF> B;
  const int threads = B::threads(pr);
  if (threads > cm90::max_threads(F::NL, E, KT, BT, DF) || pr.ncomp != B::NC || pr.lanes < 1 || pr.lanes > cm90::WARP || (pr.lanes & (pr.lanes - 1)) ||
      pr.tn < 1 || pr.kg < 1 || pr.bg < 1 || pr.chunk < 1 || pr.nchunks < 1 ||
      pr.fwarps < 1 || pr.fwarps > cm90::FINISH_THREADS / cm90::WARP || (pr.fwarps & (pr.fwarps - 1)) ||
      (long long)pr.chunk * pr.nchunks < pr.n || (DF && cm90::k_tiles<KT, BT>(pr) != 1))
    return (int)cudaErrorInvalidValue;
  if (mode & 1) {
    const size_t smem = B::smem_bytes(pr);
    static size_t smem_set = 0;  // the instance's opt-in so far (each cudaFuncSetAttribute costs host time)
    if (smem > smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(commit_sm90_partial<F, E, KT, BT, DF>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      smem_set = smem;
    }
    cudaError_t err;
    dim3 grid(cm90::groups<KT, BT>(pr), pr.nchunks);  // a chunk's groups side by side: they share rows in L2
    commit_sm90_partial<F, E, KT, BT, DF><<<grid, threads, smem, stream>>>(pr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (mode & 2)
    commit_sm90_finish<F, E><<<(unsigned)cm90::Finish<F, E>::blocks(pr), cm90::FINISH_THREADS, 0, stream>>>(
        pr, F::from(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// consts: the field's u64 words (latticefold_torch/cuda.py:field_constants).
// (nl, e, kt, bt, direct) must be one of the instances below (direct: f
// read from device memory, one tile along k), and the plan
// (rings/mxu.py:commit_sm90_plan) legal: anything else returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int lf_commit_sm90(const void* A, const void* Fw, const void* red, void* partial, void* out, int kappa,
                              int n, int Nb, int ncomp, int e, int nl, int kt, int bt, int direct, int kg, int bg,
                              int lanes, int tn, int chunk, int nchunks, int fwarps, int mode,
                              const u64* consts, void* stream) {
  const cm90::Problem pr{(const long long*)A, (const long long*)Fw, (const long long*)red, (u64*)partial,
                         (long long*)out, kappa, n, Nb, ncomp, kg, bg, lanes, tn, chunk, nchunks, fwarps};
  cudaStream_t s = (cudaStream_t)stream;
#define LF_COMMIT_SM90(FT, EE, KT, BT)                                                                  \
  if (nl == FT::NL && e == EE && kt == KT && bt == BT)                                                \
    return direct ? launch<FT, EE, KT, BT, true>(pr, mode, consts, s) : launch<FT, EE, KT, BT, false>(pr, mode, consts, s);
  LF_COMMIT_SM90(F32, 9, 1, 1)
  LF_COMMIT_SM90(F64, 3, 1, 1)
  LF_COMMIT_SM90(F64, 4, 2, 1)
  LF_COMMIT_SM90(F64, 4, 1, 1)
  LF_COMMIT_SM90(F256, 1, 1, 2)
  LF_COMMIT_SM90(F256, 1, 2, 1)
  LF_COMMIT_SM90(F256, 1, 1, 1)
#undef LF_COMMIT_SM90
  return (int)cudaErrorInvalidValue;
}
