// Exact arithmetic mod a prime q < 2^64 (two 32-bit limbs, nl = 2) for the
// port's hand-written Hopper kernels.
//
// Values live in u64 registers. A 64x64 product is formed exactly with the
// native 64-bit multiply and __umul64hi; products are summed lazily in a
// 192-bit accumulator (three u64 words) and reduced once at the end. The
// reduction maps T to T * 2^-64 mod q, which is the Montgomery product with
// R = 2^64 = 2^(32 nl): summing raw products of Montgomery-form operands and
// reducing once gives the same canonical Montgomery limbs as the JAX
// package's per-term CIOS mont_mul followed by modular adds.

#pragma once

#include <cstdint>

typedef unsigned long long u64;

struct Field64 {
  u64 q;     // the prime, q < 2^64
  u64 ninv;  // -q^{-1} mod 2^64
  u64 r1;    // 2^64 mod q
  u64 r2;    // 2^128 mod q
};

struct Acc192 {
  u64 w0, w1, w2;
};

__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 q) {
  // a, b < q: the true sum is < 2q, and a wrap past 2^64 means it is >= q
  u64 s = a + b;
  return (s < a || s >= q) ? s - q : s;
}

// Montgomery product a*b*2^-64 mod q, canonical. Valid whenever
// a*b < q * 2^64 (in particular for a, b < q, or a < 2^64 and b < q).
__device__ __forceinline__ u64 mont_mul64(u64 a, u64 b, const Field64& f) {
  u64 lo = a * b;
  u64 hi = __umul64hi(a, b);
  u64 m = lo * f.ninv;
  u64 mh = __umul64hi(m, f.q);
  // lo + lo(m q) == 0 mod 2^64, with a carry out iff lo != 0
  u64 c = lo != 0 ? 1ull : 0ull;
  u64 s = hi + mh;
  bool over = s < hi;
  u64 s2 = s + c;
  over |= s2 < s;
  // the true value (a b + m q) / 2^64 is < 2q
  return (over || s2 >= f.q) ? s2 - f.q : s2;
}

__device__ __forceinline__ void acc_zero(Acc192& a) {
  a.w0 = 0;
  a.w1 = 0;
  a.w2 = 0;
}

// a += x * y (exact, 128-bit product into 192 bits)
__device__ __forceinline__ void mac192(Acc192& a, u64 x, u64 y) {
  u64 lo = x * y;
  u64 hi = __umul64hi(x, y);  // <= 2^64 - 2, so hi + carry cannot wrap
  a.w0 += lo;
  hi += a.w0 < lo ? 1ull : 0ull;
  a.w1 += hi;
  a.w2 += a.w1 < hi ? 1ull : 0ull;
}

// a += b
__device__ __forceinline__ void add192(Acc192& a, const Acc192& b) {
  a.w0 += b.w0;
  u64 c0 = a.w0 < b.w0 ? 1ull : 0ull;
  u64 t = a.w1 + b.w1;
  u64 c1 = t < b.w1 ? 1ull : 0ull;
  u64 t2 = t + c0;
  c1 += t2 < t ? 1ull : 0ull;
  a.w1 = t2;
  a.w2 += b.w2 + c1;
}

// T * 2^-64 mod q for T = w0 + w1 2^64 + w2 2^128, canonical:
//   w0 2^-64 + w1 + w2 2^64  =  mont(w0, 1) + mont(w1, r1) + mont(w2, r2).
__device__ __forceinline__ u64 redc192(const Acc192& a, const Field64& f) {
  u64 x = mont_mul64(a.w0, 1ull, f);
  u64 y = mont_mul64(a.w1, f.r1, f);
  u64 z = mont_mul64(a.w2, f.r2, f);
  return add_mod(add_mod(x, y, f.q), z, f.q);
}

// Two int64 lanes holding 32-bit limbs (the port's tensor layout) <-> u64.
__device__ __forceinline__ u64 load_limbs(const long long* p) {
  return (u64)p[0] | ((u64)p[1] << 32);
}

__device__ __forceinline__ void store_limbs(long long* p, u64 v) {
  p[0] = (long long)(v & 0xFFFFFFFFull);
  p[1] = (long long)(v >> 32);
}
