// Kernel D: the TPU probes that move data without a dot.
//
// lf_dma_checksum replaces the DMA-only kernels of the commit-dot probes,
// benches/exp_r4_kvar2.py `dma_kernel` and exp_r4_kvar3.py `dma_kernel`.
// Those read one element of each block and add it to a block-dependent
// output: what they measure is the copy of every block of A and W into fast
// memory. Here every byte of A ([c, Mpad, K] or [c, K, Mpad] int8) and of W
// ([c, K, L] u32) is read once with 16-byte loads, and the output is
// independent of any block size: per component c, the sum mod 2^32 of A's
// bytes as int8 plus W's words. Device memory bounds it (it is the probe of
// that bound). Per-component sizes must be multiples of 16 bytes, and the
// pointers 16-byte aligned (the wrapper checks).
//
// lf_bitcast_u8 and lf_merge_minor replace benches/exp_pallas_probe.py's
// `k_bitcast` (u32 [8, 128] -> its bytes as u8 [8, 512]) and `k_merge`
// ([8, 16, 4] -> [8, 64]): byte-exact copies, launch-bound at these sizes.
// On contiguous little-endian memory both functions are the identity on
// bytes (the bitcast's bytes are the words' bytes in order; the merge's
// rows are the input's rows), so each is one block copying 16-byte vectors,
// with no integer division, and a 4-byte scalar tail only where the size is
// not a multiple of 16 bytes (pointers 16-byte aligned: the launcher
// checks). lf_bitcast_u8_v1 and lf_merge_minor_v1 are the first design (a
// thread per word: four single-byte stores, or four 64-bit divisions or
// modulos), the in-call baseline that chip_smoke.py times, launched by no
// path.

#include <cuda_runtime.h>

typedef unsigned int u32;

namespace {

__device__ __forceinline__ u32 sum_i8x4(u32 x) {
  return (u32)((int)(signed char)x + (int)(signed char)(x >> 8) + (int)(signed char)(x >> 16) +
               (int)(signed char)(x >> 24));
}

__global__ void dma_checksum_kernel(const uint4* __restrict__ A, long long a16,
                                    const uint4* __restrict__ W, long long w16,
                                    u32* __restrict__ out) {
  const int c = blockIdx.y;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* Ac = A + c * a16;
  const uint4* Wc = W + c * w16;
  u32 s = 0;
  for (long long i = start; i < a16; i += stride) {
    const uint4 v = Ac[i];
    s += sum_i8x4(v.x) + sum_i8x4(v.y) + sum_i8x4(v.z) + sum_i8x4(v.w);
  }
  for (long long i = start; i < w16; i += stride) {
    const uint4 v = Wc[i];
    s += v.x + v.y + v.z + v.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(out + c, s);  // mod 2^32 in any order
}

__global__ void bitcast_u8_kernel(const u32* __restrict__ x, long long nwords,
                                  unsigned char* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nwords) return;
  const u32 v = x[i];
#pragma unroll
  for (int b = 0; b < 4; ++b) out[4 * i + b] = (unsigned char)(v >> (8 * b));
}

__global__ void merge_minor_kernel(const u32* __restrict__ y, int R, int X, int NL,
                                   u32* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * X * NL) return;
  const int r = (int)(i / ((long long)X * NL)), x = (int)(i / NL % X), l = (int)(i % NL);
  out[(long long)r * X * NL + x * NL + l] = y[((long long)r * X + x) * NL + l];
}

constexpr int COPY_THREADS = 256;

// one block: words [0, n16) as 16-byte vectors, then the tail's 4-byte words
__device__ __forceinline__ void copy16(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16,
                                       int tail_words) {
  for (long long i = threadIdx.x; i < n16; i += COPY_THREADS) dst[i] = src[i];
  if (threadIdx.x < tail_words)
    reinterpret_cast<u32*>(dst + n16)[threadIdx.x] = reinterpret_cast<const u32*>(src + n16)[threadIdx.x];
}

__global__ void __launch_bounds__(COPY_THREADS)
    bitcast_u8_vec_kernel(const uint4* __restrict__ x, long long n16, int tail_words, uint4* __restrict__ out) {
  copy16(x, out, n16, tail_words);
}

__global__ void __launch_bounds__(COPY_THREADS)
    merge_minor_vec_kernel(const uint4* __restrict__ y, long long n16, int tail_words, uint4* __restrict__ out) {
  copy16(y, out, n16, tail_words);
}

}  // namespace

// a_bytes, w_words: per component; out: c u32, zeroed by the caller.
extern "C" int lf_dma_checksum(const void* A, long long a_bytes, const void* W, long long w_words,
                               void* out, int c, int blocks, void* stream) {
  if (a_bytes % 16 || w_words % 4) return (int)cudaErrorInvalidValue;
  dim3 grid(blocks, c);
  dma_checksum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)A, a_bytes / 16, (const uint4*)W, w_words / 4, (u32*)out);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

extern "C" int lf_bitcast_u8(const void* x, long long nwords, void* out, void* stream) {
  if (nwords < 0 || !aligned16(x) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  bitcast_u8_vec_kernel<<<1, COPY_THREADS, 0, (cudaStream_t)stream>>>((const uint4*)x, nwords / 4, (int)(nwords % 4),
                                                                        (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" int lf_merge_minor(const void* y, int R, int X, int NL, void* out, void* stream) {
  const long long total = (long long)R * X * NL;
  if (total < 0 || !aligned16(y) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  merge_minor_vec_kernel<<<1, COPY_THREADS, 0, (cudaStream_t)stream>>>((const uint4*)y, total / 4, (int)(total % 4),
                                                                         (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" int lf_bitcast_u8_v1(const void* x, long long nwords, void* out, void* stream) {
  bitcast_u8_kernel<<<(unsigned)((nwords + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const u32*)x, nwords, (unsigned char*)out);
  return (int)cudaGetLastError();
}

extern "C" int lf_merge_minor_v1(const void* y, int R, int X, int NL, void* out, void* stream) {
  const long long total = (long long)R * X * NL;
  merge_minor_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const u32*)y, R, X, NL, (u32*)out);
  return (int)cudaGetLastError();
}
