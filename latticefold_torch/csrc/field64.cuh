// Exact arithmetic mod a prime q < 2^64 (two 32-bit limbs, nl = 2:
// Goldilocks, Frog) for the port's hand-written Hopper kernels; the
// interface is described in field_common.cuh.
//
// Values live in u64 registers. A 64x64 product is formed exactly with the
// native 64-bit multiply and the high product; products are summed lazily
// in a 192-bit accumulator (three u64 words) and reduced once at the end.
// The reduction maps T to T * 2^-64 mod q, which is the Montgomery product
// with R = 2^64 = 2^(32 nl).

#pragma once

#include "field_common.cuh"

struct F64 {
  static constexpr int NL = 2;
  typedef u64 Elem;
  struct Acc {
    u64 w0, w1, w2;
  };

  u64 q;     // the prime, q < 2^64
  u64 ninv;  // -q^-1 mod 2^64
  u64 r1;    // 2^64 mod q
  u64 r2;    // 2^128 mod q

  static F64 from(const u64* c) { return F64{c[0], c[1], c[2], c[3]}; }

  // two int64 lanes holding 32-bit limbs (the port's tensor layout) <-> u64
  LF_DEV static Elem load(const long long* p) {
    return (u64)p[0] | ((u64)p[1] << 32);
  }
  LF_DEV static void store(long long* p, Elem v) {
    p[0] = (long long)(v & 0xFFFFFFFFull);
    p[1] = (long long)(v >> 32);
  }

  LF_DEV static void zero(Acc& a) {
    a.w0 = 0;
    a.w1 = 0;
    a.w2 = 0;
  }

  // a += x * y (exact, 128-bit product into 192 bits)
  LF_DEV static void mac(Acc& a, Elem x, Elem y) {
    const u64 lo = x * y;
    u64 hi = lf_mulhi(x, y);  // <= 2^64 - 2, so hi + carry cannot wrap
    a.w0 += lo;
    hi += a.w0 < lo ? 1ull : 0ull;
    a.w1 += hi;
    a.w2 += a.w1 < hi ? 1ull : 0ull;
  }

  LF_DEV Elem add(Elem a, Elem b) const {
    // a, b < q: the true sum is < 2q, and a wrap past 2^64 means it is >= q
    const u64 s = a + b;
    return (s < a || s >= q) ? s - q : s;
  }

  // Montgomery product a b 2^-64 mod q, canonical. Valid whenever
  // a b < q 2^64 (in particular for a, b < q, or a < 2^64 and b < q).
  LF_DEV Elem mul(Elem a, Elem b) const {
    const u64 lo = a * b;
    const u64 hi = lf_mulhi(a, b);
    const u64 m = lo * ninv;
    const u64 mh = lf_mulhi(m, q);
    // lo + lo(m q) == 0 mod 2^64, with a carry out iff lo != 0
    const u64 c = lo != 0 ? 1ull : 0ull;
    const u64 s = hi + mh;
    bool over = s < hi;
    const u64 s2 = s + c;
    over |= s2 < s;
    // the true value (a b + m q) / 2^64 is < 2q
    return (over || s2 >= q) ? s2 - q : s2;
  }

  // T 2^-64 mod q for T = w0 + w1 2^64 + w2 2^128, canonical:
  //   w0 2^-64 + w1 + w2 2^64  =  mul(w0, 1) + mul(w1, r1) + mul(w2, r2).
  LF_DEV Elem reduce(const Acc& a) const {
    return add(add(mul(a.w0, 1ull), mul(a.w1, r1)), mul(a.w2, r2));
  }
};
