// The Hopper byte dot shared by kernel A's dot (plane_dot_sm90_kernel.cu)
// and kernel C's GEMM (int_gemm_sm90_kernel.cu): a transposed tile
// D[column, row] = X^T[column, k] x A^T[k, row] on
// wgmma.m64nNk32.s32.{s8,u8}, with X staged as 32-bit words and built into
// registers (plane_frags_sm90.cuh) and A's rows read by wgmma from
// TMA-loaded, 128-byte-swizzled K-major stages.
//
// - A block owns one row group of N rows of A, a tile of WT = 32 words of X
//   (128 columns: 64 per consumer warpgroup, which share each staged A tile)
//   and one K split; blockIdx = (word tile, K split + ksplit x row group,
//   component c).
// - One producer thread keeps a ring of STAGES stages of KB = 128 k in
//   flight, each tracked by a `full` and an `empty` mbarrier: per stage one
//   TMA box of A ([N rows, 128 k], 128-byte swizzle) and one of X
//   ([128 k, WT words] of u32 words, 128-byte swizzle, or of int64 lanes as
//   they lie). TMA zero-fills rows past M, k past the split's end and
//   words past L.
// - KMAJOR: A arrives MN-major ([c, Ks, M], kernel A's K-major lhs), which
//   the 8-bit wgmma cannot read. TMA loads the raw [128 k, N rows] box, and
//   the consumers transpose it (transpose_stage) into one of two K-major
//   swizzled copies, the next stage's while this step's wgmma is in flight.
//   Then a fence.proxy.async.shared::cta (the generic stores, before the
//   async proxy's wgmma reads them) and, at the top of the next step, a
//   named barrier of the 256 consumers: both warpgroups wrote the copy, and
//   both waited for the wgmma that read the other copy, which the transpose
//   after the barrier overwrites. The arrive on a stage's `empty` barrier
//   follows its transpose and its register build, so the producer cannot
//   refill a raw stage before it was read.
// - GEMM false (kernel A): P[c, row, plane L + word], the K splits added
//   with int32 atomics into an `out` zeroed by the caller. GEMM true
//   (kernel C): C[row, 4 word + byte] (int_gemm_sm90.cuh), the K splits
//   reduced in the launch by the last split to arrive.
// - The tensor maps come from cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint(ByVersion) (no -lcuda), built on the host (the
//   last few per thread kept by their arguments: an encode is host time in
//   a launch-bound call) and passed by value as __grid_constant__
//   parameters. A tensor map
//   takes row strides that are multiples of 16 bytes only: the wrappers
//   raise on others or copy into such storage.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstring>

#include "int_gemm_sm90.cuh"
#include "plane_frags_sm90.cuh"
#include "sm90_async.cuh"
#include "wgmma_s8.cuh"

namespace sm90 {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

// LB: the bytes of X's lanes (8: int64 lanes or u32 words, unswizzled; 4:
// u32 words staged with the 128-byte swizzle, plane_frags_sm90.cuh
// w_index_sw)
template <int N_, bool KMAJOR, int LB>
struct Cfg {
  static constexpr int N = N_;
  static constexpr int NC = 2;                    // consumer warpgroups, one word sub-tile each
  static constexpr int WT = WSUB * NC;            // words per block
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int A_BYTES = N * KB;          // the stage's A tile (raw MN-major when KMAJOR)
  static constexpr int W_BYTES = KB * WT * LB;    // the stage's words
  static constexpr int T_BYTES = KMAJOR ? N * KB : 0;  // each of the two K-major copies
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int FIT = (SMEM_MAX - 1024 - 128 - 2 * T_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 1024 + 2 * T_BYTES + STAGES * STAGE + 128;
  static_assert(STAGES >= 2, "a stage ring needs two stages");
  static_assert(!KMAJOR || N % 32 == 0, "the K-major transpose takes 32 rows a unit");
};

// where and how the accumulators go
struct Out {
  int* out;           // kernel A: P [c, M, 4 L]; kernel C: C [M, ncols], contiguous
  int* ws;            // kernel C: the split workspace (int_gemm_sm90.cuh)
  int* counters;      // kernel C: a counter per tile, 0 between launches
  int wbytes;         // bytes of X's lanes: 4 (u32 words) or 8 (int64 lanes)
  int M, Ks, L;       // A's rows, the contraction, X's words
  int ncols;          // kernel C: C's columns
  int ksplit, kper;   // K splits and the k of each (a multiple of KB)
};

__device__ __forceinline__ void tma_load_3d(u32 dst, const CUtensorMap* map, u32 bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"((unsigned long long)map), "r"(bar), "r"(x), "r"(y), "r"(z) : "memory");
}

template <int N, bool KMAJOR, int FRAG, bool U8, bool GEMM, int LB>
__global__ void __launch_bounds__(Cfg<N, KMAJOR, LB>::THREADS, 1)
    dot_sm90(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap, const Out o) {
  using C = Cfg<N, KMAJOR, LB>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes of the shared address
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* t_s = base;                             // [2][N][KB] K-major copies (KMAJOR)
  unsigned char* a_s = base + 2 * C::T_BYTES;            // [STAGES][N][KB] or raw [STAGES][KB][N]
  unsigned char* w_s = a_s + C::STAGES * C::A_BYTES;     // [STAGES][KB][WT] words
  unsigned long long* bars = (unsigned long long*)(w_s + C::STAGES * C::W_BYTES);
  volatile int* last_flag = (volatile int*)(bars + 2 * C::STAGES);
  const u32 full0 = smem_u32(bars), empty0 = smem_u32(bars + C::STAGES);

  const int o0 = blockIdx.x * C::WT, c = blockIdx.z;
  const int split = blockIdx.y % o.ksplit, rgroup = blockIdx.y / o.ksplit, row0 = rgroup * N;
  const int kbeg = split * o.kper, kend = min(o.Ks, kbeg + o.kper);
  const int steps = (kend - kbeg + KB - 1) / KB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    // the tensor maps' descriptors, fetched while the barriers are set up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((unsigned long long)&amap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((unsigned long long)&wmap) : "memory");
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
      const u32 tx = C::A_BYTES + KB * C::WT * o.wbytes;
      for (int it = 0; it < steps; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        const int k0 = kbeg + it * KB;
        mbar_arrive_expect_tx(full0 + 8 * s, tx);
        if (KMAJOR) {
          tma_load_3d(smem_u32(a_s + s * C::A_BYTES), &amap, full0 + 8 * s, row0, k0, c);
        } else {
          tma_load_3d(smem_u32(a_s + s * C::A_BYTES), &amap, full0 + 8 * s, k0, row0, c);
        }
        tma_load_3d(smem_u32(w_s + s * C::W_BYTES), &wmap, full0 + 8 * s, o0, k0, c);
      }
    }
    return;
  }

  // consumer warpgroups
  const int ct = threadIdx.x;  // 0 .. 255
  const int wsub = warp >> 2, wq = warp & 3;
  const int col = frag_col(wsub, wq, lane);
  const int wstride = o.wbytes / 4;
  int acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0;
  const u32 copy0 = smem_u32(t_s);
  if (KMAJOR) {
    // stage 0's transpose; then each step's transpose of the next stage
    // runs while the step's wgmma is in flight
    mbar_wait(full0, 0);
    transpose_stage<N>((const u32*)a_s, (u32*)t_s, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int it = 0; it < steps; ++it) {
    const int s = it % C::STAGES;
    u32 tile = smem_u32(a_s + s * C::A_BYTES);
    if (KMAJOR) {
      // both warpgroups wrote copy it & 1, and both finished the wgmma of
      // step it - 1, which read the copy that the next transpose overwrites
      named_sync<1, 128 * C::NC>();
      tile = copy0 + (it & 1) * C::T_BYTES;
    } else {
      mbar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
    }
    u32 a[KB / 32][4];
    const u32* ws = (const u32*)(w_s + s * C::W_BYTES);
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks) plane_frags<FRAG, LB == 4>(a[ks], ws, C::WT, wstride, col, ks, lane);
    if (KMAJOR) mbar_arrive(empty0 + 8 * s);  // the raw stage is transposed, its words are in registers
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks) Wgmma<N, U8>::mma(acc, a[ks], desc_sw128(tile + 32 * ks));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (KMAJOR && it + 1 < steps) {
      const int s1 = (it + 1) % C::STAGES;
      mbar_wait(full0 + 8 * s1, ((it + 1) / C::STAGES) & 1);
      transpose_stage<N>((const u32*)(a_s + s1 * C::A_BYTES), (u32*)(t_s + ((it + 1) & 1) * C::T_BYTES), warp,
                         lane);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if (!KMAJOR) mbar_arrive(empty0 + 8 * s);
  }

  if (GEMM) {
    const int tile_id = gemm_tile(rgroup, blockIdx.x, gridDim.x);
    if (o.ksplit > 1) {
      ws_store(o.ws + ws_slot(tile_id, split, o.ksplit, N / 2), acc, ct);
      __threadfence();
      named_sync<2, 128 * C::NC>();
      if (ct == 0) *last_flag = last_split(atomicAdd(o.counters + tile_id, 1), o.ksplit);
      named_sync<2, 128 * C::NC>();
      if (!*last_flag) return;
      __threadfence();
      fixup_sum(acc, o.ws, tile_id, split, o.ksplit, ct, [](int (&v)[4], const int* p) {
        const int4 x = __ldcg((const int4*)p);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      });
      if (ct == 0) o.counters[tile_id] = 0;
    }
    const int col0 = 4 * o0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const int row = row0 + acc_row(lane, j), cc = col0 + gemm_col(wsub, wq, lane, j);
      if (row < o.M && cc < o.ncols) o.out[(long long)row * o.ncols + cc] = acc[j];
    }
  } else {
    const int word = o0 + WSUB * wsub + acc_word(wq, lane);
    if (word < o.L) {
      const long long NN = 4LL * o.L;
      int* ob = o.out + (long long)c * o.M * NN + word;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const int row = row0 + acc_row(lane, j);
        if (row < o.M) {
          int* p = ob + row * NN + acc_plane(lane, j) * o.L;
          if (o.ksplit > 1) {
            atomicAdd(p, acc[j]);
          } else {
            *p = acc[j];
          }
        }
      }
    }
  }
}

template <int N, bool KMAJOR, int FRAG, bool U8, bool GEMM, int LB>
int launch_dot(const CUtensorMap& amap, const CUtensorMap& wmap, const Out& o, dim3 grid, cudaStream_t s) {
  using C = Cfg<N, KMAJOR, LB>;
  auto kern = dot_sm90<N, KMAJOR, FRAG, U8, GEMM, LB>;
  static bool smem_set = false;  // the instance's opt-in (each cudaFuncSetAttribute costs host time)
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  kern<<<grid, C::THREADS, C::SMEM, s>>>(amap, wmap, o);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// a tensor map's arguments: the map is a function of these alone
struct MapArgs {
  long long p, d0, d1, d2, s1, s2, type, b0, b1, swizzle;
};

// a 3-D tensor map of dims {d0, d1, d2} (d0 contiguous), byte strides s1, s2
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* p, long long d0, long long d1,
                       long long d2, long long s1, long long s2, int b0, int b1, CUtensorMapSwizzle swizzle) {
  constexpr int KEPT = 8;  // the maps this thread encoded last, reused round robin
  thread_local MapArgs kept_args[KEPT];
  thread_local CUtensorMap kept[KEPT];
  thread_local int kept_n = 0, next = 0;
  const MapArgs args{(long long)p, d0, d1, d2, s1, s2, (long long)type, b0, b1, (long long)swizzle};
  for (int i = 0; i < kept_n; ++i)
    if (std::memcmp(&kept_args[i], &args, sizeof args) == 0) {
      *map = kept[i];
      return true;
    }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, type, 3, (void*)p, dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  kept_args[next] = args;
  kept[next] = *map;
  next = (next + 1) % KEPT;
  if (kept_n < KEPT) ++kept_n;
  return true;
}

}  // namespace sm90
