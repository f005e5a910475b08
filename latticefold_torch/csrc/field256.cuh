// Exact arithmetic mod a prime q < 2^252 (eight 32-bit limbs, nl = 8:
// Stark) for the port's hand-written Hopper kernels; the interface is
// described in field_common.cuh.
//
// A value is four u64 words. mac forms the exact 512-bit product by
// schoolbook (16 64x64 products) and adds it into a 576-bit accumulator
// (nine words), which takes 2^70 products of values below 2^252 without
// overflow. The Montgomery radix is R = 2^256, so reduce maps
// T = t0 + t1 2^256 + t2 2^512 (t0, t1 < 2^256, t2 < 2^64) to
//   T R^-1 = mul(t0, 1) + mul(t1, R mod q) + mul(t2, R^2 mod q)   (mod q),
// where mul is a four-word CIOS Montgomery product; each of the three
// calls has a b < q R, so its result is below 2q before the final subtract.

#pragma once

#include "field_common.cuh"

struct U256 {
  u64 w[4];
};

struct F256 {
  static constexpr int NL = 8;
  typedef U256 Elem;
  struct Acc {
    u64 w[9];
  };

  U256 q;    // the prime, q < 2^252
  u64 ninv;  // -q^-1 mod 2^64
  U256 r1;   // 2^256 mod q
  U256 r2;   // 2^512 mod q

  static F256 from(const u64* c) {
    return F256{{{c[0], c[1], c[2], c[3]}},
                c[4],
                {{c[5], c[6], c[7], c[8]}},
                {{c[9], c[10], c[11], c[12]}}};
  }

  LF_DEV static Elem load(const long long* p) {
    Elem v;
#pragma unroll
    for (int i = 0; i < 4; ++i) v.w[i] = (u64)p[2 * i] | ((u64)p[2 * i + 1] << 32);
    return v;
  }
  LF_DEV static void store(long long* p, const Elem& v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = (long long)(v.w[i] & 0xFFFFFFFFull);
      p[2 * i + 1] = (long long)(v.w[i] >> 32);
    }
  }

  LF_DEV static void zero(Acc& a) {
#pragma unroll
    for (int k = 0; k < 9; ++k) a.w[k] = 0;
  }

  // a += x * y, exact
  LF_DEV static void mac(Acc& a, const Elem& x, const Elem& y) {
    u64 p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u64 c = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) lf_mad2(x.w[i], y.w[j], p[i + j], c, p[i + j], c);
      p[i + 4] = c;
    }
    u64 c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const u64 s = a.w[k] + p[k];
      u64 c1 = s < p[k] ? 1ull : 0ull;
      const u64 s2 = s + c;
      c1 += s2 < c ? 1ull : 0ull;  // at most one of the two carries is set
      a.w[k] = s2;
      c = c1;
    }
    a.w[8] += c;
  }

  // t + top 2^256 (known < 2q) -> canonical
  LF_DEV Elem reduce_once(const u64* t, u64 top) const {
    Elem d;
    u64 borrow = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const u64 x = t[i] - q.w[i];
      const u64 b1 = t[i] < q.w[i] ? 1ull : 0ull;
      d.w[i] = x - borrow;
      borrow = b1 | (x < borrow ? 1ull : 0ull);
    }
    if (top != 0 || borrow == 0) return d;
    Elem s;
#pragma unroll
    for (int i = 0; i < 4; ++i) s.w[i] = t[i];
    return s;
  }

  LF_DEV Elem add(const Elem& a, const Elem& b) const {
    // a, b < q < 2^252: the sum needs no fifth word
    u64 s[4];
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const u64 x = a.w[i] + b.w[i];
      const u64 c1 = x < a.w[i] ? 1ull : 0ull;
      s[i] = x + c;
      c = c1 | (s[i] < c ? 1ull : 0ull);
    }
    return reduce_once(s, 0);
  }

  // CIOS Montgomery product a b 2^-256 mod q, canonical, for a b < q 2^256
  // (a < 2^256 and b < q suffice)
  LF_DEV Elem mul(const Elem& a, const Elem& b) const {
    u64 t[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u64 c = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) lf_mad2(a.w[i], b.w[j], t[j], c, t[j], c);
      u64 s = t[4] + c;
      t[5] = s < c ? 1ull : 0ull;
      t[4] = s;
      const u64 m = t[0] * ninv;
      u64 lo;
      lf_mad2(m, q.w[0], t[0], 0ull, lo, c);  // lo == 0
#pragma unroll
      for (int j = 1; j < 4; ++j) lf_mad2(m, q.w[j], t[j], c, t[j - 1], c);
      s = t[4] + c;
      t[3] = s;
      t[4] = t[5] + (s < c ? 1ull : 0ull);
      t[5] = 0;
    }
    return reduce_once(t, t[4]);
  }

  LF_DEV Elem reduce(const Acc& a) const {
    const Elem one = {{1ull, 0ull, 0ull, 0ull}};
    const Elem t0 = {{a.w[0], a.w[1], a.w[2], a.w[3]}};
    const Elem t1 = {{a.w[4], a.w[5], a.w[6], a.w[7]}};
    const Elem t2 = {{a.w[8], 0ull, 0ull, 0ull}};
    return add(add(mul(t0, one), mul(t1, r1)), mul(t2, r2));
  }
};
