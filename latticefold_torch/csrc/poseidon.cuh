// The Poseidon permutation's arithmetic, on the field types of
// field32/64/256.cuh (shared by csrc/poseidon_kernel.cu and, as plain C++,
// by the CPU test tests/test_torch_csrc_poseidon.py).
//
// A round of the ark sponge (latticefold_torch/transcript/poseidon.py
// `_permute`): add the round constant to every word; the s-box x^7 on every
// word in a full round, on word 0 only in a partial one; then the MDS
// product. Values are Montgomery (R = 2^(32 nl)) and canonical; ARK and MDS
// are Montgomery constants, so out_i = sum_j MDS_ij s_j R^-1, which is one
// lazy sum of exact products (F::mac) reduced once (F::reduce): the same
// canonical value as the JAX package's per-term Montgomery products and
// modular adds (transcript/device.py `permute`).
//
// Two forms of the permutation live here. The round-by-round form
// (`lf_poseidon_serial`, the first kernel's lanes) runs every round as
// written. The factored form (`lf_poseidon_fast_serial`, the sponge
// kernel's rounds) is the equivalent one of the Poseidon paper (eprint
// 2019/458, appendix B): the partial rounds' constants are moved forward
// through the linear layers, so a partial round adds one scalar to word 0
// and the first full round after them takes what is left; and the MDS
// matrix of each partial round is factored as S B, B = diag(1, A) moved
// back into the round before, so a partial round multiplies by the sparse
// S alone (word 0 a t-term dot, word i > 0 s_i + v_i s_0) and the last full
// round before them by the dense B_1 M; the partial rounds' dots are then
// unrolled (below), so a round's chain is its s-box, one product and a
// reduction. The host builds the constants exactly mod q
// (latticefold_torch/transcript/device.py `fast_consts`); the values are
// equal, not approximately so.
#pragma once

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"

// x^7: x^2, then x^3 and x^4, then their product (three dependent products)
template <class F>
LF_DEV typename F::Elem lf_pow7(const F& f, const typename F::Elem& x) {
  const typename F::Elem x2 = f.mul(x, x);
  const typename F::Elem x3 = f.mul(x2, x);
  const typename F::Elem x4 = f.mul(x2, x2);
  return f.mul(x3, x4);
}

// Round r's add and s-box for word i
template <class F>
LF_DEV typename F::Elem lf_round_sbox(const F& f, typename F::Elem x,
                                      const typename F::Elem& ark, bool full,
                                      int i) {
  x = f.add(x, ark);
  return (full || i == 0) ? lf_pow7(f, x) : x;
}

// Word i of the MDS product: sum_j MDS_ij s[j] R^-1 mod q, MDS_ij at
// mds[i * row + j * col] (row t, col 1 row-major; row 1, col t transposed)
template <class F>
LF_DEV typename F::Elem lf_mds_row(const F& f, const typename F::Elem* mds,
                                   int row, int col, int i,
                                   const typename F::Elem* s, int t) {
  typename F::Acc acc;
  F::zero(acc);
  for (int j = 0; j < t; ++j) F::mac(acc, mds[i * row + j * col], s[j]);
  return f.reduce(acc);
}

// Whether round r of rf full and rp partial rounds is a full one
LF_DEV bool lf_full_round(int r, int rf, int rp) {
  return r < rf / 2 || r >= rf / 2 + rp;
}

// The whole permutation, one word after the other (the CPU test's path;
// the kernel runs a lane per word): state [t], ark [(rf + rp) t], mds [t t],
// scratch [t].
template <class F>
LF_DEV void lf_poseidon_serial(const F& f, typename F::Elem* state,
                               const typename F::Elem* ark,
                               const typename F::Elem* mds, int t, int rf,
                               int rp, typename F::Elem* scratch) {
  for (int r = 0; r < rf + rp; ++r) {
    const bool full = lf_full_round(r, rf, rp);
    for (int i = 0; i < t; ++i)
      scratch[i] = lf_round_sbox(f, state[i], ark[r * t + i], full, i);
    for (int i = 0; i < t; ++i) state[i] = lf_mds_row(f, mds, t, 1, i, scratch, t);
  }
}

// ---------------------------------------------------------------------------
// the factored form
// ---------------------------------------------------------------------------

// Offsets (in Elems) into the factored form's constant buffer:
//   ark  [rf, t]   the full rounds' constants (round rf/2 takes the partial
//                  rounds' carried constants too)
//   mds  [t, t]    the MDS matrix, row-major
//   pre  [t, t]    B_1 M: the matrix of full round rf/2 - 1
//   part [rp, 2t]  partial round k: its scalar constant c_k, S_k's corner
//                  s00, S_k's row 0 (words 1 .. t-1 at 2 .. t), S_k's
//                  column 0 v_k (words 1 .. t-1 at t+1 .. 2t-1)
//   cmat [rp, rp]  C_lk = sum_{j>0} S_l[0][j] v_k[j] for k < l, else 0
#ifdef __CUDACC__
#define LF_HD __host__ __device__ __forceinline__
#else
#define LF_HD inline
#endif
LF_HD int lf_off_mds(int t, int rf) { return rf * t; }
LF_HD int lf_off_pre(int t, int rf) { return rf * t + t * t; }
LF_HD int lf_off_part(int t, int rf) { return rf * t + 2 * t * t; }
LF_HD int lf_off_cmat(int t, int rf, int rp) { return rf * t + 2 * t * t + 2 * t * rp; }
LF_HD int lf_fast_elems(int t, int rf, int rp) { return rf * t + 2 * t * t + 2 * t * rp + rp * rp; }

// The partial rounds, unrolled. With the sparse matrices, a partial round
// k maps (x_0, x_j) to (s00 s_k + sum_{j>0} S_k[0][j] x_j, x_j + v_k[j] s_k),
// s_k = (x_0 + c_k)^7. So every word j > 0 is its value on entry plus
// E_j = sum_k v_k[j] s_k, and the dot of round l is
//   D_l + sum_{k<l} C_lk s_k,   D_l = sum_{j>0} S_l[0][j] x_j(entry):
// the D_l are dots of the entry state, formed before the rounds, and a round
// is then the s-box, one product and an add on the chain; the products
// C_lk s_k are added to the D_l beside it (A_l, a field value), the v_k[j]
// s_k into lazy sums reduced after the rounds.

// T R^-1 mod q for a lazy sum T: the field's reduce, but for F32 (whose
// reduce takes u64 remainders) three Montgomery products: with T = l0 +
// l1 2^32 + hi 2^64, T 2^-32 = l0 2^-32 + l1 + hi 2^32, each term a product
// a b 2^-32 with a b < q 2^32 (hi < 2^32: sums of fewer than 2^32
// products of values below 2^31). On an H100 this makes BabyBear's
// one-permutation call 1.40x faster than F32::reduce does; a Montgomery
// step for F64 was no faster than F64::reduce (tools/exp_poseidon_reduce.py).
template <class F>
LF_DEV typename F::Elem lf_reduce_fast(const F& f, const typename F::Acc& a) {
  return f.reduce(a);
}
LF_DEV u32 lf_reduce_fast(const F32& f, const F32::Acc& a) {
  const u32 r64 = (u32)f.r64;     // 2^64 mod q
  const u32 r32 = f.mul(r64, 1u);  // 2^32 mod q
  return f.add(f.add(f.mul((u32)a.lo, 1u), f.mul((u32)(a.lo >> 32), r32)), f.mul((u32)a.hi, r64));
}

// a += b for lazy sums (every Acc is little-endian u64 words)
template <class Acc>
LF_DEV void lf_acc_add(Acc& a, const Acc& b) {
  constexpr int W = (int)(sizeof(Acc) / sizeof(u64));
  u64* x = reinterpret_cast<u64*>(&a);
  const u64* y = reinterpret_cast<const u64*>(&b);
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const u64 s = x[k] + y[k];
    const u64 c1 = s < y[k] ? 1ull : 0ull;
    x[k] = s + c;
    c = c1 | (x[k] < c ? 1ull : 0ull);
  }
}

// Partial round k's new word 0, s00 s_k + A_k, where A_k = D_k + sum_{l<k}
// C_kl s_l is known before s_k (so it is formed beside the s-box, and the
// round's chain is the s-box, one product and an add)
template <class F>
LF_DEV typename F::Elem lf_partial_word0(const F& f, const typename F::Elem& a, const typename F::Elem* part_k,
                                         const typename F::Elem& s) {
  return f.add(f.mul(part_k[1], s), a);
}

// D_l: S_l's row 0 against words 1 .. t-1 of the entry state x
template <class F>
LF_DEV typename F::Elem lf_partial_dot(const F& f, const typename F::Elem* part_l, const typename F::Elem* x,
                                       int t) {
  typename F::Acc a;
  F::zero(a);
  for (int j = 1; j < t; ++j) F::mac(a, part_l[1 + j], x[j]);
  return lf_reduce_fast(f, a);
}

// The factored permutation, one word after the other (the CPU test's path;
// the sponge kernel splits the same rounds over its lanes): state [t],
// consts [lf_fast_elems], scratch [t]; t <= LF_MAX_T, rp <= LF_MAX_RP.
constexpr int LF_MAX_T = 32;
constexpr int LF_MAX_RP = 32;
template <class F>
LF_DEV void lf_poseidon_fast_serial(const F& f, typename F::Elem* x, const typename F::Elem* c, int t, int rf,
                                    int rp, typename F::Elem* s) {
  typedef typename F::Elem Elem;
  typedef typename F::Acc Acc;
  const Elem* mds = c + lf_off_mds(t, rf);
  const Elem* pre = c + lf_off_pre(t, rf);
  const Elem* part = c + lf_off_part(t, rf);
  const Elem* cmat = c + lf_off_cmat(t, rf, rp);
  for (int r = 0; r < rf; ++r) {
    if (r == rf / 2) {
      Elem a[LF_MAX_RP];
      Acc e[LF_MAX_T];
      for (int l = 0; l < rp; ++l) a[l] = lf_partial_dot(f, part + 2 * t * l, x, t);
      for (int j = 0; j < t; ++j) F::zero(e[j]);
      for (int k = 0; k < rp; ++k) {
        const Elem* pk = part + 2 * t * k;
        const Elem sk = lf_pow7(f, f.add(x[0], pk[0]));
        x[0] = lf_partial_word0(f, a[k], pk, sk);
        for (int l = 0; l < rp; ++l) a[l] = f.add(a[l], f.mul(cmat[l * rp + k], sk));
        for (int j = 1; j < t; ++j) F::mac(e[j], pk[t + j], sk);
      }
      for (int j = 1; j < t; ++j) x[j] = f.add(x[j], lf_reduce_fast(f, e[j]));
    }
    for (int i = 0; i < t; ++i) s[i] = lf_pow7(f, f.add(x[i], c[r * t + i]));
    const Elem* m = r == rf / 2 - 1 ? pre : mds;
    for (int i = 0; i < t; ++i) {
      Acc acc;
      F::zero(acc);
      for (int j = 0; j < t; ++j) F::mac(acc, m[i * t + j], s[j]);
      x[i] = lf_reduce_fast(f, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// one absorb or squeeze call of the duplex sponge
// ---------------------------------------------------------------------------
//
// The schedule of TraceSponge.absorb / squeeze (transcript/device.py) with
// rate index idx (after a mode switch: 0, the switch's permutation first)
// and n values: segments k = 0 .. nseg - 1, where segment k touches the
// rate words [w, w + cnt) (state words cap + w ..) with values [pos, pos +
// cnt) of the call (added on an absorb, written out on a squeeze), and a
// permutation follows every segment but the last.

LF_DEV int lf_call_nseg(int n, int idx, int rate) {
  if (idx + n <= rate) return 1;
  const int rem = n - (rate - idx);
  return 1 + (rem + rate - 1) / rate;
}

LF_DEV void lf_call_seg(int k, int n, int idx, int rate, int& w, int& cnt, int& pos) {
  w = k == 0 ? idx : 0;
  pos = k == 0 ? 0 : (rate - idx) + (k - 1) * rate;
  const int room = rate - w;
  cnt = n - pos < room ? n - pos : room;
}

// One call, one word after the other: vals [n] added (absorb) or out [n]
// written (squeeze, vals null); returns the rate index afterwards.
template <class F>
LF_DEV int lf_sponge_call_serial(const F& f, typename F::Elem* x, const typename F::Elem* vals,
                                 typename F::Elem* out, int n, int idx, bool sw, int t, int rate, int rf, int rp,
                                 const typename F::Elem* c, typename F::Elem* s) {
  const int cap = t - rate;
  if (sw) {
    lf_poseidon_fast_serial(f, x, c, t, rf, rp, s);
    idx = 0;
  }
  const int nseg = lf_call_nseg(n, idx, rate);
  int w = 0, cnt = 0, pos = 0;
  for (int k = 0; k < nseg; ++k) {
    lf_call_seg(k, n, idx, rate, w, cnt, pos);
    for (int j = 0; j < cnt; ++j) {
      if (vals)
        x[cap + w + j] = f.add(x[cap + w + j], vals[pos + j]);
      else
        out[pos + j] = x[cap + w + j];
    }
    if (k + 1 < nseg) lf_poseidon_fast_serial(f, x, c, t, rf, rp, s);
  }
  return w + cnt;
}
