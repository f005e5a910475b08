// Tensor-core tile pieces shared by the plane-dot kernel (plane_dot_kernel.cu)
// and the probe GEMM (int_gemm_kernel.cu): mma.sync wrappers, fragment loads
// from shared-memory tiles, and tile loads from device memory.
//
// Tiles in shared memory are TILE rows of K-contiguous bytes with a row
// pitch of PITCH bytes (64 + 16: the fragment loads below then hit 32
// distinct banks). An A tile holds rows m, a B tile holds columns n, both
// K-contiguous, which is what mma.sync's row.col fragments read:
//   m16n8k32 (s8/u8): A reg r = row g + 8 (r & 1), bytes k 4t + 16 (r >> 1);
//                     B reg r = column g, bytes k 4t + 16 r;
//   m16n8k16 (bf16):  A reg r = row g + 8 (r & 1), k 2t + 8 (r >> 1), +1;
//                     B reg r = column g, k 2t + 8 r, +1;
//   C (s32 or f32):   reg r = row g + 8 (r >> 1), column 2t + (r & 1),
// with g = lane / 4 and t = lane % 4.

#pragma once

#include <cuda_runtime.h>

typedef unsigned int u32;

namespace mma {

constexpr int TILE = 64;          // rows (or columns) of a tile, and its K depth
constexpr int PITCH = TILE + 16;  // bytes per tile row in shared memory

__device__ __forceinline__ void mma_s8(int (&d)[4], const u32 (&a)[4], const u32 (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const u32 (&a)[4], const u32 (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const u32 (&a)[4], const u32 (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ u32 ld32(const unsigned char* p) {
  return *reinterpret_cast<const u32*>(p);
}

// m16n8k32 fragments at (row0 or col0, k0) of a K-contiguous tile
__device__ __forceinline__ void frag_a8(u32 (&a)[4], const unsigned char* tile, int row0, int k0, int lane) {
  const unsigned char* p = tile + (row0 + (lane >> 2)) * PITCH + k0 + 4 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * PITCH);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * PITCH + 16);
}

__device__ __forceinline__ void frag_b8(u32 (&b)[2], const unsigned char* tile, int col0, int k0, int lane) {
  const unsigned char* p = tile + (col0 + (lane >> 2)) * PITCH + k0 + 4 * (lane & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 16);
}

// two bytes (values 0..255) -> two bf16 in one register, lower k in the low
// half; a byte value is exact in bf16 (8 significant bits)
__device__ __forceinline__ u32 bf16x2_of_bytes(const unsigned char* p) {
  return (__float_as_uint((float)p[0]) >> 16) | (__float_as_uint((float)p[1]) & 0xFFFF0000u);
}

// m16n8k16 bf16 fragments of u8 tiles, converted on the way
__device__ __forceinline__ void frag_a16(u32 (&a)[4], const unsigned char* tile, int row0, int k0, int lane) {
  const unsigned char* p = tile + (row0 + (lane >> 2)) * PITCH + k0 + 2 * (lane & 3);
  a[0] = bf16x2_of_bytes(p);
  a[1] = bf16x2_of_bytes(p + 8 * PITCH);
  a[2] = bf16x2_of_bytes(p + 8);
  a[3] = bf16x2_of_bytes(p + 8 * PITCH + 8);
}

__device__ __forceinline__ void frag_b16(u32 (&b)[2], const unsigned char* tile, int col0, int k0, int lane) {
  const unsigned char* p = tile + (col0 + (lane >> 2)) * PITCH + k0 + 2 * (lane & 3);
  b[0] = bf16x2_of_bytes(p);
  b[1] = bf16x2_of_bytes(p + 8);
}

// The TILE x TILE byte tile at (r0, k0) of a matrix, staged through
// registers: fetch() issues every global load of the calling thread (NT
// threads share a tile), store() writes them to shared memory as tile[r][k]
// (K-contiguous), so a kernel can fetch the next tile while it computes on
// this one. Rows >= R and k >= K are zero. The matrix is row-major (element
// (r, k) at src[r * ld + k]) or, with KMAJOR, K-major (at src[k * ld + r]:
// 16 consecutive r of one k are read at once and written down a column of
// the tile -- the transpose happens here; sm_90 has no 8-bit
// ldmatrix.trans). vec: src and ld are 16-byte aligned, so whole 16-byte
// chunks are read with one load each.
template <int NT, bool KMAJOR>
struct TileLoader {
  static constexpr int PER = TILE * TILE / 16 / NT;
  uint4 v[PER];

  __device__ __forceinline__ void fetch(const unsigned char* src, long long ld, int r0, int R,
                                        int k0, int K, bool vec) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int id = threadIdx.x + i * NT;
      // a chunk is 16 bytes along the contiguous axis
      const int outer = id >> 2, inner = (id & 3) * 16;
      const int gr = KMAJOR ? r0 + inner : r0 + outer;
      const int gk = KMAJOR ? k0 + outer : k0 + inner;
      const bool live = KMAJOR ? gk < K : gr < R;
      const int lim = KMAJOR ? R - gr : K - gk;  // valid bytes in the chunk
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (live) {
        const unsigned char* p = KMAJOR ? src + (long long)gk * ld + gr : src + (long long)gr * ld + gk;
        if (vec && lim >= 16) {
          v[i] = *reinterpret_cast<const uint4*>(p);
        } else {
          __align__(16) unsigned char b[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) b[j] = j < lim ? p[j] : 0;
          v[i] = *reinterpret_cast<const uint4*>(b);
        }
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* tile) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int id = threadIdx.x + i * NT;
      const int outer = id >> 2, inner = (id & 3) * 16;
      if (KMAJOR) {
        const unsigned char* b = reinterpret_cast<const unsigned char*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 16; ++j) tile[(inner + j) * PITCH + outer] = b[j];
      } else {
        *reinterpret_cast<uint4*>(tile + outer * PITCH + inner) = v[i];
      }
    }
  }
};

}  // namespace mma
