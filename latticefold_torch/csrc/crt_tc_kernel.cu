// CRT / ICRT of a batch of ring elements on Hopper's u8 tensor cores: a
// constant d x d matrix over F_q applied to every element's d-vector, exact,
// for the four rings' (nl, d).
//
// Replaces: latticefold_tpu/rings/pallas_crt.py `_fused_fn` (its `kernel`,
// launched through `crt` / `icrt` via `_apply`), and takes its route: the
// matrix, prescaled by 2^32 R mod q, as a conv-folded byte matrix C
// (rings/ops.py `conv_matrix`), one dot of the elements' bytes with C, a
// base-256 carry and a wide Montgomery reduction by 2^(32 (nl + 1))
// (plane_epilogue.cuh). The TPU kernel runs the dot in bf16 on its matrix
// unit; here it is wgmma.m64n128k32.s32.u8.u8, exact (every sum has at most
// 4 d nl <= 512 terms below 2^16). csrc/crt_kernel.cu (32-bit multiply-adds
// on the CUDA cores) stays as the baseline chip_smoke.py times beside it.
//
// What bounds it: per element it reads and writes d nl u32 limbs (int64
// lanes in the port's tensors: 8 B a limb) and needs d^2 (4 nl)^2 byte
// products, two operations each: 4 d nl = 128 to 512 operations per byte
// at 4 B a limb, under the card's 1979e12 / 3.35e12 = 590, so device memory
// bounds it at every ring (the wgmmas issue twice those operations: C's
// 8 nl columns per output are half zeros). The carry and wide reduction,
// ~1000 32-bit operations per output at nl 8, run on the CUDA cores beside
// the dot.
//
// Design (crt_tc.cuh has the index maps):
// - A block holds NC consumer warpgroups of ROWS = 64 elements each and one
//   producer warp. A consumer loads its elements' limbs straight into its
//   wgmma A-operand registers (4 d nl / 32 steps of four registers: each
//   register is the low half of one int64 lane) and keeps them for the
//   whole matrix: the elements are read from device memory once.
// - C lives in device memory (and L2) as chunks of 128 columns, the byte
//   positions of 128 / (8 nl) outputs (Stark's 512 KB do not fit in shared
//   memory; BabyBear's 240 KB neither), already in the 128-byte swizzle the
//   wgmma descriptor names. The producer streams them through a ring of
//   STAGES shared-memory stages with 1-D bulk copies (cp.async.bulk, no
//   tensor map), each tracked by a `full` and an `empty` mbarrier; every
//   consumer warpgroup of the block reads each stage.
// - Per chunk a consumer runs 4 d nl / 32 wgmmas into 64 s32 accumulators,
//   releases the stage, stages the accumulators in shared memory (one row
//   per element) and finishes its 64 x 128 / (8 nl) outputs: one thread
//   per (element, output) gathers the 8 nl position sums, carries them a
//   limb at a time, reduces them and writes the nl limbs; neighbouring
//   threads write neighbouring outputs of one element.
// - Per ring (the launcher's table): at nl 1 and 2 one consumer warpgroup a
//   block and two or three blocks an SM, so that one block's loads, dot,
//   finish and stores overlap another's; at Stark two warpgroups a block
//   share each 64 KB chunk, which halves the bytes of C each element costs
//   in L2 traffic (a block streams all 512 KB).
// - Tried and dropped (PERF.md): persistent blocks that load the next
//   tile's A operand during this one (no faster); a warpgroup finishing one
//   chunk while its wgmmas of the next run (ptxas serializes the wgmmas,
//   C7518, and Stark is slower); two warpgroups a block at nl 1 and 2.
// - No fallback: an mbarrier wait traps after a bounded poll instead of
//   holding the card, and an (nl, d) without an instance returns
//   cudaErrorInvalidValue.
//
// Input  x     : [N, d, nl] int64 (u32 limbs, Montgomery form)
// Matrix tiles : rings/ops.py `conv_tiles`, uint8, 16-byte aligned
// Output out   : [N, d, nl] int64, out[n, o] = sum_i M[o, i] x[n, i] R^-1 mod q

#include <cuda_runtime.h>

#include "crt_tc.cuh"
#include "sm90_async.cuh"
#include "wgmma_s8.cuh"

namespace crt_tc {

// NC consumer warpgroups of ROWS elements a block, STAGES chunk stages,
// MINB blocks an SM (the launcher's table picks them per ring)
template <int NL, int D, int NC_, int STAGES_, int MINB_>
struct Cfg : Shape<NL, D> {
  static constexpr int NC = NC_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int SMEM = 1024 + STAGES * Shape<NL, D>::CHUNK_BYTES + NC * ROWS * PITCH * 4 + 16 * STAGES;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// the NL limbs into int64 lanes at dst, as predicated 16-byte stores (8-byte
// at NL = 1), when `valid`
template <int NL>
__device__ __forceinline__ void store_limbs(bool valid, long long* dst, const u32 (&limbs)[NL]) {
  if constexpr (NL == 1) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p st.global.u64 [%1], %2;\n}\n"
                 ::"r"((int)valid), "l"(dst), "l"((u64)limbs[0]) : "memory");
  } else {
#pragma unroll
    for (int l = 0; l < NL; l += 2)
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p st.global.v2.u64 [%1], {%2, %3};\n}\n"
                   ::"r"((int)valid), "l"(dst + l), "l"((u64)limbs[l]), "l"((u64)limbs[l + 1]) : "memory");
  }
}

template <class C, int NL, int D>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    crt_tc_kernel(const long long* __restrict__ x, const unsigned char* __restrict__ tiles,
                  long long* __restrict__ out, int N, WideRedc<NL> wr) {
  using namespace sm90;
  constexpr int NC = C::NC, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes of the shared address
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* b_s = base;                                      // [STAGES][CHUNK_BYTES]
  int* staged = (int*)(base + STAGES * C::CHUNK_BYTES);           // [NC][ROWS][PITCH]
  unsigned long long* bars = (unsigned long long*)(staged + NC * ROWS * PITCH);
  const u32 full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);          // the producer's expect_tx; the copy's bytes
      mbar_init(empty0 + 8 * s, 128 * NC);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // producer: one thread streams the chunks of C
    if (lane == 0) {
      for (int ch = 0; ch < C::NCH; ++ch) {
        const int s = ch % STAGES;
        mbar_wait(empty0 + 8 * s, ((ch / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full0 + 8 * s, C::CHUNK_BYTES);
        bulk_load(smem_u32(b_s + s * C::CHUNK_BYTES), tiles + (size_t)ch * C::CHUNK_BYTES, C::CHUNK_BYTES,
                  full0 + 8 * s);
      }
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3, tid = threadIdx.x & 127;
  const int row0 = (blockIdx.x * NC + wg) * ROWS;  // the warpgroup's first element
  int* st = staged + wg * ROWS * PITCH;
  // the A operand for every step: limbs as the low halves of the int64 lanes
  const u32* xw = reinterpret_cast<const u32*>(x);
  u32 a[C::KS][4];
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + a_row(w, lane, r);
      a[ks][r] = row < N ? __ldg(xw + 2 * ((size_t)row * C::DNL + a_limb(lane, ks, r))) : 0u;
    }

  for (int ch = 0; ch < C::NCH; ++ch) {
    const int s = ch % STAGES;
    mbar_wait(full0 + 8 * s, (ch / STAGES) & 1);
    int acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0;
    const u32 tile = smem_u32(b_s + s * C::CHUNK_BYTES);
    __syncwarp();  // the .aligned wgmma instructions need the warp converged
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) WgmmaU8N128::mma(acc, a[ks], desc_sw128(tile + b_step(ks)));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);

    // stage the sums, once the warpgroup's finish of the last chunk has read its own
    if (wg == 0) named_sync<1, 128>(); else named_sync<2, 128>();
#pragma unroll
    for (int j = 0; j < 64; j += 2)
      *reinterpret_cast<int2*>(st + stage_index(acc_row(w, lane, j), acc_col(lane, j))) =
          make_int2(acc[j], acc[j + 1]);
    if (wg == 0) named_sync<1, 128>(); else named_sync<2, 128>();

    // the finish: carry, reduce and write the chunk's outputs of the warpgroup's elements
#pragma unroll
    for (int it = 0; it < C::PAIRS; ++it) {
      const int p = tid + 128 * it;
      const int row = pair_row(C::CPC, p), oc = pair_out(C::CPC, p);
      const int o = ch * C::CPC + oc;
      // no branch: every thread of the warpgroup runs the finish (the staged
      // rows and outputs past N and d read as sums of zeros), and only the
      // stores are predicated; branching around the finish was slower
      const bool valid = row0 + row < N && o < D;
      int4 u[2 * NL];  // every load before the carry chain
      const int4* src = reinterpret_cast<const int4*>(st + stage_index(row, oc * C::SP));
#pragma unroll
      for (int v = 0; v < 2 * NL; ++v) u[v] = src[v];
      u32 limbs[NL];
      finish_output<NL>(u, wr, limbs);
      store_limbs<NL>(valid, out + ((size_t)(row0 + row) * D + o) * NL, limbs);
    }
  }
}

template <int NL, int D, int NC, int STAGES, int MINB>
int launch(const void* x, const void* tiles, void* out, int N, const u64* consts, cudaStream_t s) {
  using C = Cfg<NL, D, NC, STAGES, MINB>;
  auto kern = crt_tc_kernel<C, NL, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (N + NC * ROWS - 1) / (NC * ROWS);
  kern<<<blocks, C::THREADS, C::SMEM, s>>>((const long long*)x, (const unsigned char*)tiles, (long long*)out, N,
                                           WideRedc<NL>::from(consts));
  return (int)cudaGetLastError();
}

}  // namespace crt_tc

// consts: the field's u64 words (latticefold_torch/cuda.py:field_constants);
// tiles: rings/ops.py `conv_tiles` of the ring and direction
extern "C" int lf_crt_tc(const void* x, const void* tiles, void* out, int N, int d, int nl, const u64* consts,
                         void* stream) {
  using namespace crt_tc;
  if (N <= 0) return 0;
  if ((unsigned long long)tiles % 16 || (unsigned long long)out % 16 || (unsigned long long)x % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // (nl, d): NC, STAGES, MINB. One warpgroup a block and two or three
  // blocks an SM at nl 1 and 2, where the elements are few bytes and a
  // block's phases (loads, dot, finish, stores) overlap best across blocks;
  // two warpgroups sharing each of Stark's 64 KB chunks, so that each block
  // streams the 512 KB matrix from L2 for 128 elements
  if (nl == 1 && d == 72) return launch<1, 72, 1, 1, 2>(x, tiles, out, N, consts, s);  // BabyBear
  if (nl == 2 && d == 24) return launch<2, 24, 1, 2, 2>(x, tiles, out, N, consts, s);  // Goldilocks
  if (nl == 2 && d == 16) return launch<2, 16, 1, 2, 3>(x, tiles, out, N, consts, s);  // Frog
  if (nl == 8 && d == 16) return launch<8, 16, 2, 2, 1>(x, tiles, out, N, consts, s);  // Stark
  return (int)cudaErrorInvalidValue;
}
