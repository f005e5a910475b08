// Shared definitions of the port's field headers (field32.cuh, field64.cuh,
// field256.cuh).
//
// Each header defines one field type, a struct holding the modulus'
// constants that a kernel takes by value, with one interface:
//   Elem                  one F_q value (u32, u64 or U256) in registers or
//                         shared memory, Montgomery form with R = 2^(32 nl)
//   Acc                   a lazy sum of exact products of Elems
//   NL                    32-bit limbs per value in the port's tensors
//   from(c)               (host) the struct from the u64 words that
//                         latticefold_torch/cuda.py:field_constants gives
//   load(p) / store(p, v) NL int64 lanes, one u32 limb each <-> Elem
//   zero(a), mac(a, x, y) a = 0; a += x * y, exact
//   reduce(a)             (sum of x*y) * R^-1 mod q, canonical
//   mul(x, y)             x * y * R^-1 mod q, canonical (Montgomery product)
//   add(x, y)             x + y mod q, canonical
// Summing raw products and reducing once gives the same canonical limbs as
// the JAX package's per-term Montgomery products followed by modular adds.
//
// The arithmetic also compiles as plain C++ (g++), where LF_DEV is `inline`
// and the 64-bit high product comes from unsigned __int128: the CPU tests
// hold the three field types against Python integers that way.

#pragma once

#include <cstdint>

typedef unsigned int u32;
typedef unsigned long long u64;

#ifdef __CUDACC__
#define LF_DEV __device__ __forceinline__
LF_DEV u64 lf_mulhi(u64 a, u64 b) { return __umul64hi(a, b); }
#else
#define LF_DEV inline
inline u64 lf_mulhi(u64 a, u64 b) {
  return (u64)(((unsigned __int128)a * b) >> 64);
}
#endif

// (hi, lo) = x * y + a + b, exact: the sum is at most 2^128 - 1.
LF_DEV void lf_mad2(u64 x, u64 y, u64 a, u64 b, u64& lo, u64& hi) {
  lo = x * y;
  hi = lf_mulhi(x, y);
  lo += a;
  hi += lo < a ? 1ull : 0ull;
  lo += b;
  hi += lo < b ? 1ull : 0ull;
}
