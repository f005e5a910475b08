// Hopper's asynchronous pieces shared by the wgmma kernels
// (plane_dot_sm90_kernel.cu, crt_tc_kernel.cu): shared-memory addresses,
// mbarriers, 1-D bulk copies, named barriers, the 128-byte-swizzle
// shared-memory descriptor of a K-major wgmma operand, and the register
// fence around a wgmma's accumulators.

#pragma once

typedef unsigned int u32;
typedef unsigned long long u64;

namespace sm90 {

__device__ __forceinline__ u32 smem_u32(const void* p) {
  return (u32)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u32 bar, u32 count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(u32 bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(u32 bar, u32 bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a fault in the ring) traps instead of holding the card
__device__ __forceinline__ void mbar_wait(u32 bar, u32 parity) {
  u32 done;
  unsigned long long tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++tries == (1ull << 26)) asm volatile("trap;");
  } while (!done);
}

// one bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory into shared memory, its bytes counted on `bar`
__device__ __forceinline__ void bulk_load(u32 dst, const void* src, u32 bytes, u32 bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"((unsigned long long)src), "r"(bytes), "r"(bar) : "memory");
}

// barrier ID (1 .. 15; 0 is __syncthreads) among COUNT threads (an
// immediate ID: a register operand makes ptxas reserve all 16 barriers)
template <int ID, int COUNT>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

// shared-memory descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzle (what TMA wrote), 8-row groups 1024 bytes apart
__device__ __forceinline__ u64 desc_sw128(u32 addr) {
  return (u64)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((u64)(1024 >> 4) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace sm90
