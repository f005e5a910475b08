// Per-output arithmetic of the byte-plane commit's epilogue
// (plane_epilogue_kernel.cu): the base-256 carry of byte-position sums into
// 32-bit limbs and the wide Montgomery reduction by R2 = 2^(32 (NL + 1)),
// as the JAX package's rings/mxu.py `_carry_pack` and `_redc_wide` do them.
// The tensor-core CRT (crt_tc.cuh) runs the same reduction.
//
// Like the field headers it compiles as plain C++ too (field_common.cuh),
// so the CPU tests hold it against Python integers with g++.

#pragma once

#include "field_common.cuh"

// u[0 .. nu) byte-position sums (u[s] weighs 2^(8 s)) -> T as 2NL+1 u32
// limbs in t[0 .. 2NL], plus a zero guard limb t[2NL+1]. Requires
// T < 2^(32 (2NL+1)), which holds for T = sum of n < 2^32 products of two
// values below 2^(32 NL).
template <int NL>
LF_DEV void carry_pack(const u64* u, int nu, u32* t) {
  constexpr int LIMBS = 2 * NL + 1;
#pragma unroll
  for (int i = 0; i <= LIMBS; ++i) t[i] = 0;
  u64 carry = 0;
  for (int s = 0; s < 4 * LIMBS; ++s) {
    const u64 v = (s < nu ? u[s] : 0ull) + carry;
    t[s >> 2] |= (u32)(v & 0xFFull) << (8 * (s & 3));
    carry = v >> 8;
  }
}

// The same T from any u64 position sums, a limb at a time: limb L takes
// the low words of u[4L .. 4L+3] and the high words of u[4L-4 .. 4L-1], each
// at shifts 0, 8, 16, 24 (each part below 2^58), and the carry of limb L - 1,
// so the carry chain is 2NL+1 steps, not 8NL+4.
template <int NL>
LF_DEV void carry_limbs64(const u64* u, int nu, u32* t) {
  constexpr int LIMBS = 2 * NL + 1;
  u64 carry = 0;
#pragma unroll
  for (int L = 0; L < LIMBS; ++L) {
    u64 w = carry;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = 4 * L + b;
      if (s < nu) w += (u[s] & 0xFFFFFFFFull) << (8 * b);
      if (L > 0 && s - 4 < nu) w += (u[s - 4] >> 32) << (8 * b);
    }
    t[L] = (u32)w;
    carry = w >> 32;
  }
  t[LIMBS] = 0;
}

template <int NL>
struct WideRedc {
  u32 q[NL];
  u32 ninv;  // -q^-1 mod 2^32

  // from the u64 words of latticefold_torch/cuda.py:field_constants: q is in
  // the first (NL + 1) / 2 words, little-endian, and the next word's low
  // half is -q^-1 mod 2^32 (it holds -q^-1 mod 2^32 or mod 2^64)
  static WideRedc from(const u64* c) {
    WideRedc r;
    for (int i = 0; i < NL; ++i) r.q[i] = (u32)(c[i / 2] >> (32 * (i % 2)));
    r.ninv = (u32)c[(NL + 1) / 2];
    return r;
  }

  // t: 2NL+1 limbs of T and a zero guard limb (carry_pack's output); out:
  // T 2^(-32 (NL + 1)) mod q, canonical. Requires T < q 2^(32 (NL + 1)).
  // Each round zeroes the lowest live limb with mu = t_r (-q^-1), adds
  // mu q and ripples the carry into the guard; t is overwritten.
  LF_DEV void reduce(u32* t, u32* out) const {
    constexpr int W = 2 * NL + 2;
#pragma unroll
    for (int r = 0; r <= NL; ++r) {
      const u32 mu = t[r] * ninv;
      u64 c = 0;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const u64 p = (u64)mu * q[j] + t[r + j] + c;  // <= 2^64 - 1
        t[r + j] = (u32)p;
        c = p >> 32;
      }
      for (int j = r + NL; j < W; ++j) {
        const u64 s = (u64)t[j] + c;
        t[j] = (u32)s;
        c = s >> 32;
      }
    }
    // the value, below 2q, is in t[NL+1 .. 2NL+1]: subtract q once if needed
    const u32* v = t + NL + 1;
    u32 d[NL];
    u64 borrow = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const u64 x = (u64)v[i] - q[i] - borrow;
      d[i] = (u32)x;
      borrow = x >> 63;
    }
    const bool ge = v[NL] != 0 || borrow == 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) out[i] = ge ? d[i] : v[i];
  }
};
