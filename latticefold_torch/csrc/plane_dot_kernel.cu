// Kernel A: the signed-int8 byte-plane dot of the Ajtai commit, per
// component c of one contraction slice,
//   P[c, m, b L + o] = sum_k A[c, m, k] * (int8)(byte b of (W[c, k, o] ^ 0x80808080)),
// on Hopper's int8 tensor cores (mma.sync m16n8k32 s8.s8 -> s32).
//
// Replaces: latticefold_tpu/rings/pallas_commit.py `_fused_slice` (kernel
// `_dot_kernel`), which is benches/exp_r4_kvar.py `kern_v2`, and the probes
// of the same dot: exp_r4_kvar.py `kern_v1` (the same function),
// `kern_planes_only` and `kern_dot_only`, exp_r4_kvar2.py `batched_kernel`
// (the same function with every c in one block; here the grid spans c and
// the tiles) and exp_r4_kvar3.py `kmajor_kernel` (A stored K-major).
//
// What bounds it: per component it reads Mpad Ks bytes of A and Ks L words
// of W and does 2 Mpad Ks 4L int8 operations. At the commit's shapes
// (Mpad 224, L 96 or 384) that is about 2 Mpad 4L / (Mpad + 4L) = 280 to
// 390 operations per byte, below the card's 1979e12 / 3.35e12 = 590: device
// memory bounds it. W's words are read once per 64-row tile of A.
// Design: a block owns 64 rows of A and 16 words of W, i.e. the 64 plane
// columns {b L + o}; its four warps own 32 rows x 8 words (4 byte planes x
// 8 columns). Per 64-deep step it stages A's tile (K-contiguous; a K-major
// A is transposed on the way) and W's words in shared memory. The B
// fragments are built from the words in registers: a fragment register is
// byte b of four consecutive k of one word, so each lane reads four words
// (k 4t .. 4t+3) and gathers byte b of each with prmt (__byte_perm), then
// XORs 0x80 into every byte: the planes never reach device memory. One set
// of four words gives the fragments of all four planes. K, rows and words
// past the ends are zero-filled or masked. Each step's global loads go to
// registers while the previous step computes, and to shared memory after
// it (mma_tile.cuh's TileLoader). Where the tiles alone would give
// the card too few warps to hide the loads' latency, the grid also splits
// K, and the splits add into `out` (zeroed by the caller) with int32
// atomics, exact in any order.
//
// A   : [c, M, Ks] int8 with strides (as0, as1, 1), or K-major [c, Ks, M]
//       with strides (as0, as1, 1)
// W   : [c, Ks, L] u32 words with strides (ws0, ws1, 1), as u32 or as
//       int64 lanes (the port's limb tensors)
// out : [c, M, 4L] int32, contiguous
// Modes: 0 full; 1 planes only (row 0 = the column sums of the planes,
// other rows 0; A is not read, no MMA); 2 dot only (fake planes: the low
// byte of each word, no XOR, for every byte; a timing probe).

#include "mma_tile.cuh"

namespace {

using namespace mma;

constexpr int THREADS = 128;
constexpr int BW = 16;          // W words per block tile: 64 plane columns
constexpr int WPITCH = BW + 2;  // u32 per staged W row: fragment reads hit 32 banks

// fragment registers bf[b][r] of the four byte planes of staged word column
// `col` at depth k0 (see mma_tile.cuh for the register layout)
template <bool FAKE>
__device__ __forceinline__ void plane_frags(u32 (&bf)[4][2], const u32* w_s, int col, int k0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const u32* p = w_s + (k0 + 16 * r + 4 * t) * WPITCH + col;
    u32 x0 = p[0], x1 = p[WPITCH], x2 = p[2 * WPITCH], x3 = p[3 * WPITCH];
    if (FAKE) {
      const u32 v = __byte_perm(__byte_perm(x0, x1, 0x40), __byte_perm(x2, x3, 0x40), 0x5410);
#pragma unroll
      for (int b = 0; b < 4; ++b) bf[b][r] = v;
    } else {
      x0 ^= 0x80808080u;
      x1 ^= 0x80808080u;
      x2 ^= 0x80808080u;
      x3 ^= 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const u32 sel = b | ((b + 4) << 4);
        bf[b][r] = __byte_perm(__byte_perm(x0, x1, sel), __byte_perm(x2, x3, sel), 0x5410);
      }
    }
  }
}

template <int MODE, bool KMAJOR, typename WT>
__global__ void __launch_bounds__(THREADS)
    plane_dot_kernel(const unsigned char* __restrict__ A, long long as0, long long as1,
                     const WT* __restrict__ W, long long ws0, long long ws1,
                     int* __restrict__ out, int M, int Ks, int L, int ksplit, int kper,
                     bool vec) {
  __shared__ __align__(16) unsigned char a_s[TILE * PITCH];
  __shared__ u32 w_s[TILE * WPITCH];
  const int c = blockIdx.z / ksplit;
  const int kbeg = (blockIdx.z % ksplit) * kper;
  const int kend = min(Ks, kbeg + kper);
  const int m0 = blockIdx.y * TILE;
  const int o0 = blockIdx.x * BW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mw = (warp >> 1) * 32;  // the warp's rows in the tile
  const int cw = (warp & 1) * 8;    // the warp's words in the tile
  const unsigned char* Ac = A + c * as0;
  const WT* Wc = W + c * ws0;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][b][r] = 0;

  // W's tile: BW words of TILE k, fetched into registers like A's
  constexpr int WPER = TILE * BW / THREADS;
  u32 wv[WPER];
  auto fetch_w = [&](int k0) {
#pragma unroll
    for (int i = 0; i < WPER; ++i) {
      const int id = threadIdx.x + i * THREADS;
      const int gk = k0 + id / BW, gw = o0 + id % BW;
      wv[i] = (gk < kend && gw < L) ? (u32)Wc[gk * ws1 + gw] : 0u;
    }
  };
  TileLoader<THREADS, KMAJOR> a_ld;
  a_ld.fetch(Ac, as1, m0, M, kbeg, kend, vec);
  fetch_w(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += TILE) {
    __syncthreads();  // the previous step's fragments are read
    a_ld.store(a_s);
#pragma unroll
    for (int i = 0; i < WPER; ++i) {
      const int id = threadIdx.x + i * THREADS;
      w_s[(id / BW) * WPITCH + id % BW] = wv[i];
    }
    __syncthreads();
    if (k0 + TILE < kend) {  // the next step's loads fly while this one computes
      a_ld.fetch(Ac, as1, m0, M, k0 + TILE, kend, vec);
      fetch_w(k0 + TILE);
    }
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 32) {
      u32 bf[4][2];
      plane_frags<MODE == 2>(bf, w_s, cw + (lane >> 2), kk, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        u32 a[4];
        frag_a8(a, a_s, mw + 16 * mi, kk, lane);
#pragma unroll
        for (int b = 0; b < 4; ++b) mma_s8(acc[mi][b], a, bf[b]);
      }
    }
  }

  const int g = lane >> 2, t = lane & 3;
  const long long N = 4LL * L;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + mw + 16 * mi + g + 8 * (r >> 1);
        const int o = o0 + cw + 2 * t + (r & 1);
        if (row < M && o < L) {
          int* p = out + ((long long)c * M + row) * N + (long long)b * L + o;
          if (ksplit > 1) {
            atomicAdd(p, acc[mi][b][r]);
          } else {
            *p = acc[mi][b][r];
          }
        }
      }
}

// mode 1: column sums of the signed planes into row 0 of `out` (zeroed by
// the caller). A block owns 32 words of one component and one K split; its
// 8 warps take every 8th k, and the block adds its sums with int32 atomics.
constexpr int SUM_WORDS = 32;
constexpr int SUM_GROUPS = 8;

template <typename WT>
__global__ void __launch_bounds__(SUM_WORDS * SUM_GROUPS)
    plane_sums_kernel(const WT* __restrict__ W, long long ws0, long long ws1,
                      int* __restrict__ out, int M, int Ks, int L, int ksplit, int kper) {
  __shared__ int part[SUM_GROUPS][4][SUM_WORDS];
  const int c = blockIdx.y / ksplit;
  const int kbeg = (blockIdx.y % ksplit) * kper;
  const int kend = min(Ks, kbeg + kper);
  const int lw = threadIdx.x % SUM_WORDS, grp = threadIdx.x / SUM_WORDS;
  const int o = blockIdx.x * SUM_WORDS + lw;
  const WT* Wc = W + c * ws0;
  int s[4] = {0, 0, 0, 0};
  if (o < L) {
    for (int k = kbeg + grp; k < kend; k += SUM_GROUPS) {
      const u32 x = (u32)Wc[k * ws1 + o] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b) s[b] += (int)(signed char)(x >> (8 * b));
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) part[grp][b][lw] = s[b];
  __syncthreads();
  if (o < L && grp < 4) {
    int sum = 0;
    for (int q = 0; q < SUM_GROUPS; ++q) sum += part[q][grp][lw];
    atomicAdd(out + (long long)c * M * 4 * L + (long long)grp * L + o, sum);
  }
}

template <typename WT>
int launch(const void* A, long long as0, long long as1, const void* W, long long ws0,
           long long ws1, void* out, int c, int M, int Ks, int L, int mode, int kmajor,
           int ksplit, bool vec, cudaStream_t s) {
  const WT* w = (const WT*)W;
  const unsigned char* a = (const unsigned char*)A;
  int* o = (int*)out;
  int kper = (Ks + ksplit - 1) / ksplit;
  kper = ((kper + TILE - 1) / TILE) * TILE;
  ksplit = (Ks + kper - 1) / kper;
  if (mode == 1) {
    dim3 grid((L + SUM_WORDS - 1) / SUM_WORDS, c * ksplit);
    plane_sums_kernel<WT><<<grid, SUM_WORDS * SUM_GROUPS, 0, s>>>(w, ws0, ws1, o, M, Ks, L, ksplit,
                                                                   kper);
    return (int)cudaGetLastError();
  }
  dim3 grid((L + BW - 1) / BW, (M + TILE - 1) / TILE, c * ksplit);
#define LF_PLANE_DOT(MD, KM)                                                          \
  if (mode == MD && kmajor == KM) {                                                   \
    plane_dot_kernel<MD, KM, WT><<<grid, THREADS, 0, s>>>(a, as0, as1, w, ws0, ws1, o, \
                                                          M, Ks, L, ksplit, kper, vec); \
    return (int)cudaGetLastError();                                                   \
  }
  LF_PLANE_DOT(0, false)
  LF_PLANE_DOT(0, true)
  LF_PLANE_DOT(2, false)
#undef LF_PLANE_DOT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// wbytes: 4 (u32 words) or 8 (int64 lanes). ksplit: the K splits; out must
// be zero when it is above 1, and always in mode 1. A mode, layout or word
// size without an instance returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int lf_plane_dot(const void* A, long long as0, long long as1, const void* W,
                            long long ws0, long long ws1, int wbytes, void* out, int c,
                            int M, int Ks, int L, int mode, int kmajor, int ksplit, int vec,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ksplit < 1 || Ks < 1) return (int)cudaErrorInvalidValue;
  if (wbytes == 4)
    return launch<u32>(A, as0, as1, W, ws0, ws1, out, c, M, Ks, L, mode, kmajor, ksplit, vec != 0, s);
  if (wbytes == 8)
    return launch<long long>(A, as0, as1, W, ws0, ws1, out, c, M, Ks, L, mode, kmajor, ksplit,
                             vec != 0, s);
  return (int)cudaErrorInvalidValue;
}
