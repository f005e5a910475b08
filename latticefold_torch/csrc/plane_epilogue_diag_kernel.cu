// Kernel B on diagonals: the epilogue of the byte-plane commit, from kernel
// A's signed plane products of every slice to the commitments,
//   [n_slices, c, Mpad, 4L] int32 -> [kappa, Nb, c, e, nl] Montgomery limbs,
// for BabyBear (nl 1, e 9), Goldilocks (nl 2, e 3), Frog (nl 2, e 4) and
// Stark (nl 8, e 1), one template instance each.
//
// Replaces: latticefold_tpu/rings/pallas_commit.py `_epilogue_fused` with
// the slice corrections of `_commit_fused` before it and
// rings/mxu.py:_ext_fold after it. It takes the place of
// plane_epilogue_kernel.cu (one thread per (b, i, j) item), which stays as
// its in-call baseline.
//
// What bounds it: the bytes of P. It reads each plane product once (4
// bytes) and writes the commitments; its arithmetic is an add or two per
// plane product and a carry and a wide reduction per (i, o) patch of DA^2
// of them (DA = 4 nl).
//
// What the item-per-thread kernel did wrong: a block per (k, c) with one
// thread per (b, i, j) (one warp a block at Stark, 2 per SM), each walking
// its DA x DA patch down rows 4L words apart, its neighbours nl words to
// the side (a sector per lane at nl 8), re-reading colsum and sM per word,
// with its position sums in a dynamically indexed local array.
//
// This design (plane_epilogue_diag.cuh, whose phases the CPU test runs):
// a block owns (k, c) and nbb groups of 32 / (4 nl) consecutive b, every
// (i, j) of them. A warp takes 32 / (4 nl) patches of one (i, j); a lane
// walks one wrapped diagonal of its patch: at each step the warp reads one
// row of each of its patches, whole 32-byte sectors of P, every word read
// once. At nl 8 the block first stages its words of P, its colsum row and
// sM in shared memory (16-byte cp.async pieces of its runs of each row and
// plane, no registers held while in flight)
// and the lanes read them from there (conflict-free: the four planes'
// slots are 8 mod 32 words apart). At nl 1 and 2 a lane issues its DA
// words and their colsum and sM words from device memory at once, with no
// staging and no barrier before the sums. A lane corrects each word as it
// adds it and keeps its two position sums in registers. The u64 sums go to
// shared memory; a thread per patch carries them a limb at a time and
// reduces them; for e > 1 a thread per (b, t) folds. At most 85 registers
// a thread (64 at 8 or 16 warps), so three or four blocks share an SM and
// one block's loads overlap another's sums.
//
// P : [nsl, c, M, 4L] int32, sM: [c, nsl, M] int32, red: [e-1, e, nl] int64
//     (Montgomery coordinates of y^(e+k) mod m(y)), out: [kappa, Nb, c, e,
//     nl] int64; all contiguous.

#include <cuda_runtime.h>

#include "plane_epilogue_diag.cuh"

namespace {

// at most 85 registers a thread: at least two blocks of 16 warps, three of
// 9 or four of 8 on an SM
template <class F, int E>
__global__ void __launch_bounds__(epi_diag::max_warps(F::NL, E) * epi_diag::WARP,
                                  32 / epi_diag::max_warps(F::NL, E))
    plane_epilogue_diag_kernel(const epi_diag::Problem pr, F f, WideRedc<F::NL> wr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const epi_diag::Block<F, E> blk(pr, blockIdx.y, blockIdx.z, blockIdx.x, smem_raw);
  const int tid = threadIdx.x, nth = blockDim.x, warps = nth / epi_diag::WARP;
  blk.prologue(tid, nth);
  typedef typename epi_diag::Block<F, E>::Words Words;
  for (int si = 0; si < pr.nsl; ++si) {
    if (!blk.DIRECT) {
      if (si > 0) __syncthreads();  // the last slice's diagonals have read the tile
      blk.stage(si, tid, nth);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    for (int task = tid / epi_diag::WARP; task < blk.tasks; task += warps)
      blk.group(si, task, tid, blk.DIRECT ? blk.load(si, task, tid) : Words{});
  }
  __syncthreads();
  blk.finish(tid, nth, wr);
  if (E > 1) {
    __syncthreads();
    blk.fold(f, tid, nth);
  }
}

template <class F, int E>
int launch(const epi_diag::Problem& pr, int kappa, const u64* consts, cudaStream_t stream) {
  typedef epi_diag::Block<F, E> B;
  const size_t smem = B::smem_bytes(pr.nbb);
  cudaError_t err = cudaFuncSetAttribute(plane_epilogue_diag_kernel<F, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = B::b_per_block(pr.nbb);
  dim3 grid((pr.Nb + nb - 1) / nb, kappa, pr.ncomp);  // the b chunks of one (k, c) together
  const int threads = epi_diag::WARP * B::warps_per_block(pr.nbb, epi_diag::max_warps(F::NL, E));
  plane_epilogue_diag_kernel<F, E><<<grid, threads, smem, stream>>>(pr, F::from(consts),
                                                                  WideRedc<F::NL>::from(consts));
  return (int)cudaGetLastError();
}

}  // namespace

// consts: the field's u64 words (latticefold_torch/cuda.py:field_constants);
// nbb: b groups of 32 / (4 nl) b per block. (nl, e) must be one of the
// instances below and nbb at least 1: anything else returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int lf_plane_epilogue_diag(const void* P, const void* sM, const void* red, void* out,
                                      int nsl, int ncomp, int M, int L, int rows, int kappa,
                                      int Nb, int e, int nl, int n, int kslice, int nbb,
                                      const u64* consts, void* stream) {
  if (nbb < 1) return (int)cudaErrorInvalidValue;
  const epi_diag::Problem pr{(const int*)P, (const int*)sM, (const long long*)red, (long long*)out,
                             nsl, ncomp, M, L, rows, Nb, n, kslice, nbb};
  cudaStream_t s = (cudaStream_t)stream;
#define LF_EPILOGUE(FT, EE) \
  if (nl == FT::NL && e == EE) return launch<FT, EE>(pr, kappa, consts, s);
  LF_EPILOGUE(F32, 9)
  LF_EPILOGUE(F64, 3)
  LF_EPILOGUE(F64, 4)
  LF_EPILOGUE(F256, 1)
#undef LF_EPILOGUE
  return (int)cudaErrorInvalidValue;
}
