// The Poseidon permutation's arithmetic for one state word, on the field
// types of field32/64/256.cuh (shared by csrc/poseidon_kernel.cu and, as
// plain C++, by the CPU test tests/test_torch_csrc_poseidon.py).
//
// A round of the ark sponge (latticefold_torch/transcript/poseidon.py
// `_permute`): add the round constant to every word; the s-box x^7 on every
// word in a full round, on word 0 only in a partial one; then the MDS
// product. Values are Montgomery (R = 2^(32 nl)) and canonical; ARK and MDS
// are Montgomery constants, so out_i = sum_j MDS_ij s_j R^-1, which is one
// lazy sum of exact products (F::mac) reduced once (F::reduce): the same
// canonical value as the JAX package's per-term Montgomery products and
// modular adds (transcript/device.py `permute`).

#pragma once

#include "field_common.cuh"

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
