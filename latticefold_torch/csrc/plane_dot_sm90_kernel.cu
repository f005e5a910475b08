// Kernel A's full dot, rebuilt for Hopper: the signed-int8 byte-plane dot of
// the Ajtai commit, per component c of one contraction slice,
//   P[c, m, b L + o] = sum_k A[c, m, k] * (int8)(byte b of (W[c, k, o] ^ 0x80808080)),
// with wgmma on TMA-loaded, mbarrier-tracked shared-memory stages.
//
// Replaces: latticefold_tpu/rings/pallas_commit.py `_fused_slice` (kernel
// `_dot_kernel`), which is benches/exp_r4_kvar.py `kern_v2`, and
// benches/exp_r4_kvar2.py `batched_kernel` (the same function with every c
// in one block; here the grid spans c). The mma.sync kernel
// (plane_dot_kernel.cu) keeps `kern_v1` and the probe-only modes.
//
// What bounds it: per component it reads Mpad Ks bytes of A and Ks L words
// of W (8 bytes each as the port's int64 limb lanes) and does 2 Mpad Ks 4L
// int8 operations: 2 Mpad 4L / (Mpad + 8L) = 150 to 450 operations per
// byte at the commit's shapes (Mpad 224 .. Stark's 576), below the card's
// 1979e12 / 3.35e12 = 590, so device memory bounds it, and W's words are
// most of the bytes. (Counted at 4 bytes a word, the function itself is
// bound by operations at Stark's shape.) Each block reads its Ajtai tile
// once per word tile, so the A bytes it moves from L2 grow with L / WT.
//
// Design (plane_frags_sm90.cuh has the register layouts):
// - A block owns every Ajtai row of one row group of N <= 224 rows, a tile of
//   WT = 32 words and one K split, so W's words are read from device memory
//   once per row group: Mpad 224 is one group of 224, Frog's 416 two of 224,
//   Stark's 576 three of 192 (rings/plane_commit.py `sm90_groups`). (Every
//   row group in one block, sharing each staged W tile, was measured and
//   dropped: slower at both Mpad > 256 shapes; PERF.md. A width of 256
//   does not fit the register file: ptxas serializes its wgmmas.)
// - The transposed tile P^T[plane columns, rows] = planes^T x A^T runs on
//   wgmma.m64nNk32.s32.s8.s8: the M side is 64 plane columns (16 words x 4
//   byte planes) per consumer warpgroup, their A-operand registers built
//   from the staged words with prmt and the XOR 0x80808080, so the planes
//   never reach device or shared memory; the N side is the row group's
//   Ajtai rows, read by wgmma from shared memory, where they are K-major
//   (8-bit wgmma takes K-major operands only). The block's two consumer
//   warpgroups take word sub-tiles 0 and 1 (16 words each) and share each
//   staged A tile.
// - One producer thread keeps a ring of STAGES stages of 128 k in flight,
//   each tracked by a `full` and an `empty` mbarrier: per stage one TMA box
//   of A ([N rows, 128 k], 128-byte swizzle) and one of W
//   ([128 k, WT words] of the u32 words or int64 lanes as they lie). TMA
//   zero-fills rows past Mpad, k past the slice and words past L.
// - The tensor maps come from cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint(ByVersion) (no -lcuda), built on the host per
//   call and passed by value as __grid_constant__ parameters. A tensor map
//   takes row strides that are multiples of 16 bytes only: the wrapper
//   raises on others (rings/plane_commit.py `empty_batch` pads W's rows).
// - The grid also splits K where the tiles alone leave SMs idle; the splits
//   add into `out` (zeroed by the caller) with int32 atomics, exact in any
//   order. Every sum is below 2^31 (|A|, |plane| <= 128, Ks <= 2^15).
//
// A   : [c, M, Ks] int8, strides (as0, as1, 1) bytes
// W   : [c, Ks, L] u32 words with element strides (ws0, ws1, 1), as u32
//       (wbytes 4) or as int64 lanes (wbytes 8)
// out : [c, M, 4L] int32, contiguous
// Pointers and the strides of A and W in bytes multiples of 16.

#include <cuda.h>
#include <cuda_runtime.h>

#include "plane_frags_sm90.cuh"
#include "sm90_async.cuh"
#include "wgmma_s8.cuh"

namespace sm90 {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

template <int N_>
struct Cfg {
  static constexpr int N = N_;
  static constexpr int NC = 2;                 // consumer warpgroups, one word sub-tile each
  static constexpr int WT = WSUB * NC;         // words per block
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int A_BYTES = N * KB;       // the stage's Ajtai tile
  static constexpr int W_BYTES = KB * WT * 8;  // the stage's words, int64 lanes at most
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int FIT = (SMEM_MAX - 1024 - 128) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 128;
  static_assert(STAGES >= 2, "a stage ring needs two stages");
};

__device__ __forceinline__ void tma_load_3d(u32 dst, const CUtensorMap* map, u32 bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"((unsigned long long)map), "r"(bar), "r"(x), "r"(y), "r"(z) : "memory");
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::THREADS, 1)
    plane_dot_sm90(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                   int wbytes, int* __restrict__ out, int M, int Ks, int L, int ksplit, int kper) {
  using C = Cfg<N>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes of the shared address
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_s = base;                           // [STAGES][N][KB]
  unsigned char* w_s = base + C::STAGES * C::A_BYTES;  // [STAGES][KB][WT] words
  unsigned long long* bars = (unsigned long long*)(w_s + C::STAGES * C::W_BYTES);
  const u32 full0 = smem_u32(bars), empty0 = smem_u32(bars + C::STAGES);

  const int o0 = blockIdx.x * C::WT, c = blockIdx.z;
  const int split = blockIdx.y % ksplit, row0 = (blockIdx.y / ksplit) * N;
  const int kbeg = split * kper, kend = min(Ks, kbeg + kper);
  const int steps = (kend - kbeg + KB - 1) / KB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);              // the producer's expect_tx; TMA's bytes
      mbar_init(empty0 + 8 * s, 128 * C::NC);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::NC) {
    // producer: one thread issues every stage's boxes
    if (lane == 0) {
      const u32 tx = C::A_BYTES + KB * C::WT * wbytes;
      for (int it = 0; it < steps; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        const int k0 = kbeg + it * KB;
        mbar_arrive_expect_tx(full0 + 8 * s, tx);
        tma_load_3d(smem_u32(a_s + s * C::A_BYTES), &amap, full0 + 8 * s, k0, row0, c);
        tma_load_3d(smem_u32(w_s + s * C::W_BYTES), &wmap, full0 + 8 * s, o0, k0, c);
      }
    }
  } else {
    // consumer warpgroups
    const int wsub = warp >> 2, wq = warp & 3;
    const int col = frag_col(wsub, wq, lane);
    const int wstride = wbytes / 4;
    int acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[j] = 0;
    for (int it = 0; it < steps; ++it) {
      const int s = it % C::STAGES;
      mbar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
      u32 a[KB / 32][4];
      const u32* ws = (const u32*)(w_s + s * C::W_BYTES);
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks) plane_frags(a[ks], ws, C::WT, wstride, col, ks, lane);
      const u32 tile = smem_u32(a_s + s * C::A_BYTES);
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks) Wgmma<N>::mma(acc, a[ks], desc_sw128(tile + 32 * ks));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * s);
    }
    const int word = o0 + WSUB * wsub + acc_word(wq, lane);
    if (word < L) {
      const long long NN = 4LL * L;
      int* ob = out + (long long)c * M * NN + word;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const int row = row0 + acc_row(lane, j);
        if (row < M) {
          int* p = ob + row * NN + acc_plane(lane, j) * L;
          if (ksplit > 1) {
            atomicAdd(p, acc[j]);
          } else {
            *p = acc[j];
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

template <int N>
int launch(const CUtensorMap& amap, const CUtensorMap& wmap, int wbytes, void* out, int c, int M, int Ks,
           int L, int ksplit, int kper, int rblocks, cudaStream_t s) {
  using C = Cfg<N>;
  auto kern = plane_dot_sm90<N>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + C::WT - 1) / C::WT, ksplit * rblocks, c);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(amap, wmap, wbytes, (int*)out, M, Ks, L, ksplit, kper);
  return (int)cudaGetLastError();
}

// a 3-D tensor map of dims {d0, d1, d2} (d0 contiguous), byte strides s1, s2
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* p, long long d0, long long d1,
                long long d2, long long s1, long long s2, int b0, int b1, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, type, 3, (void*)p, dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90

// n: the row groups' width, chosen by the wrapper (rings/plane_commit.py
// `sm90_groups`); the grid spans the row groups of n rows that cover M. An n
// without an instance returns cudaErrorInvalidValue and launches nothing.
extern "C" int lf_plane_dot_sm90(const void* A, long long as0, long long as1, const void* W,
                                 long long ws0, long long ws1, int wbytes, void* out, int c, int M,
                                 int Ks, int L, int ksplit, int n, void* stream) {
  using namespace sm90;
  cudaStream_t s = (cudaStream_t)stream;
  if (ksplit < 1 || n < 1 || Ks < 1 || L < 1 || c < 1 || M < 1 || (wbytes != 4 && wbytes != 8) ||
      (unsigned long long)A % 16 || as0 % 16 || as1 % 16 || (unsigned long long)W % 16 ||
      (ws0 * wbytes) % 16 || (ws1 * wbytes) % 16)
    return (int)cudaErrorInvalidValue;
  int kper = (Ks + ksplit - 1) / ksplit;
  kper = ((kper + KB - 1) / KB) * KB;
  ksplit = (Ks + kper - 1) / kper;
  const int rblocks = (M + n - 1) / n;

  CUtensorMap amap, wmap;
  if (!tensor_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, Ks, M, c, as1, as0, KB, n, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&wmap, wbytes == 8 ? CU_TENSOR_MAP_DATA_TYPE_UINT64 : CU_TENSOR_MAP_DATA_TYPE_UINT32, W, L, Ks,
                  c, ws1 * wbytes, ws0 * wbytes, Cfg<64>::WT, KB, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;

#define LF_SM90(NN) \
  if (n == NN) return launch<NN>(amap, wmap, wbytes, out, c, M, Ks, L, ksplit, kper, rblocks, s);
  LF_SM90(64)
  LF_SM90(128)
  LF_SM90(192)
  LF_SM90(224)
#undef LF_SM90
  return (int)cudaErrorInvalidValue;
}
