// Exact arithmetic mod a prime q < 2^31 (one 32-bit limb, nl = 1: BabyBear)
// for the port's hand-written Hopper kernels; the interface is described in
// field_common.cuh.
//
// A product of two values is below 2^62, so one u64 multiply forms it
// exactly, and a 128-bit sum (two u64 words) takes 2^66 of them without
// overflow. The Montgomery radix is R = 2^32 (the port's limb width), so
// reduce maps a sum T to T * 2^-32 mod q: T mod q by u64 remainders, then
// one product with 2^-32 mod q.

#pragma once

#include "field_common.cuh"

struct F32 {
  static constexpr int NL = 1;
  typedef u32 Elem;
  struct Acc {
    u64 lo, hi;
  };

  u64 q;     // the prime, q < 2^31
  u64 ninv;  // -q^-1 mod 2^32
  u64 r64;   // 2^64 mod q
  u64 rinv;  // 2^-32 mod q

  static F32 from(const u64* c) { return F32{c[0], c[1], c[2], c[3]}; }

  LF_DEV static Elem load(const long long* p) { return (Elem)p[0]; }
  LF_DEV static void store(long long* p, Elem v) { p[0] = (long long)v; }

  LF_DEV static void zero(Acc& a) {
    a.lo = 0;
    a.hi = 0;
  }

  LF_DEV static void mac(Acc& a, Elem x, Elem y) {
    const u64 p = (u64)x * y;
    a.lo += p;
    a.hi += a.lo < p ? 1ull : 0ull;
  }

  // T = lo + hi 2^64 -> T 2^-32 mod q; every product below is < 2^62
  LF_DEV Elem reduce(const Acc& a) const {
    const u64 t = ((a.hi % q) * r64 % q + a.lo % q) % q;
    return (Elem)(t * rinv % q);
  }

  // a b 2^-32 mod q for a b < q 2^32: t + m q < 2^64 and the result < 2q
  LF_DEV Elem mul(Elem a, Elem b) const {
    const u64 t = (u64)a * b;
    const u64 m = (u64)((u32)t * (u32)ninv);
    const u64 u = (t + m * q) >> 32;
    return (Elem)(u >= q ? u - q : u);
  }

  LF_DEV Elem add(Elem a, Elem b) const {
    const u64 s = (u64)a + b;
    return (Elem)(s >= q ? s - q : s);
  }
};
