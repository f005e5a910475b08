// The block algorithm of the Hopper commit kernel (commit_sm90_kernel.cu):
// the index maps from a block, a thread and a lane to the words of A and f
// they stage and read, and the phases of a block, each run by every thread
// of its block (or lane of its warp) between barriers and reading only what
// an earlier phase wrote.
//
//   cm[k, b, c] = sum_j A[k, j, c] *_K f[j, b, c]   in K = F_q[y]/m(y)
//
// A [kappa, n, ncomp, e, nl] and f [n, Nb, ncomp, e, nl] hold Montgomery
// u32 limbs in int64 lanes; a row of either (one (k, j) or one (j, b)) is
// ROW = ncomp e nl lanes, PR = ROW / 2 pieces of 16 bytes.
//
// Pass 1 (a block per (pair group, chunk of n)). The (k, b) pairs are cut
// into tiles of KT x BT pairs, and the tiles into groups of kg x bg tiles;
// a block owns one group and one chunk [n0, n1) of n, for every component.
// It stages the group's rows of A (and, unless DF, of f), TN n at a time,
// whole rows (all components) with 16-byte copies, in two buffers: the
// copies of stage t + 1 are in flight while the threads multiply stage t. In shared memory a staged row is PP = PR
// rounded up to whole 128-byte lines, and piece p of the rows of n-row j
// lies at swz(j, p), an XOR inside its line, so that the lanes of a
// quarter warp (consecutive j, or consecutive components of one j) read
// distinct banks. With DF (one tile spans k, as at LatticeFold+'s kappa of
// 1 and 2, so that each f value has one reader) f is not staged: a thread
// loads its f values from device memory, RB rows ahead of their products.
// Thread tid is lane tid % L of item tid / L; an item is (component c,
// tile): c = item % ncomp. A thread keeps the 2e - 1 convolution
// coefficients of its KT x BT pairs in lazy sums (Lazy<F>: 32-bit carry
// chains) and adds into them the exact products of rows j = lane, lane +
// L, ... of each stage: one A value serves BT b, one f value KT k. At the
// end the L lanes of an item add their sums as the field's wide Acc (a
// shuffle tree on the card) and lane 0 writes them, unreduced, to the
// partials [nchunks, ncomp, P, 2e - 1, W] u64 (P = kappa Nb, W = the Acc's
// words). The sums have the headroom for every sum over n that the paths
// take (n e <= 2^20 products; F32 takes 2^66, F64 2^64, F256 2^70).

// Pass 2 (fwarps warps per (c, p), as many as its chunks need). Thread t
// of an output adds the partials of chunks t, t + 32 fwarps, ... as wide
// integers, shuffle trees and shared memory add the threads, lane s of the
// output's first warp reduces coefficient s once (F::reduce), and its lane
// t < e writes out_t = v_t + sum_k v_(e+k) red[k][t] (the y^(e+k) fold).
//
// Like the field headers it compiles as plain C++ too (field_common.cuh),
// so tests/test_torch_csrc_commit_tile.py runs every block of a grid with
// g++, a phase at a time over the threads, and holds the result against
// the plain commit.

#pragma once

#include <cstddef>

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"

#ifdef __CUDACC__
#define LF_CM_HD __host__ __device__ __forceinline__
#else
#include <cstring>
#define LF_CM_HD inline
#endif

namespace cm90 {

constexpr int WARP = 32;
// the most threads of a pass-1 block: 512 for the staged instances whose
// sums fit 128 registers a thread (one pair of Goldilocks, Frog or Stark),
// so that a block owns twice the pairs and stages each row for more of
// them; else 256
LF_CM_HD constexpr int max_threads(int nl, int e, int kt, int bt, bool df) {
  return !df && kt == 1 && bt == 1 && nl >= 2 ? 512 : 256;
}
constexpr int FINISH_THREADS = 256;

// the components of the one ring of each (nl, e): BabyBear 8 x F_q^9,
// Goldilocks 8 x F_q^3, Frog 4 x F_q^4, Stark 16 x F_q
LF_CM_HD constexpr int ncomp_of(int nl, int e) { return nl == 1 ? 8 : nl == 8 ? 16 : e == 3 ? 8 : 4; }

// pieces of 16 bytes in a row of ncomp e nl int64 lanes, and the staged
// row's pitch in pieces: whole 128-byte lines
LF_CM_HD constexpr int row_pieces(int ncomp, int e, int nl) { return ncomp * e * nl / 2; }
LF_CM_HD constexpr int pitch_pieces(int pr) { return (pr + 7) / 8 * 8; }

// the staged place of piece p of the rows of n-row j: an XOR of its place
// in its 128-byte line, keyed by j and the line
LF_CM_HD int swz(int j, int p) { return p ^ ((j + (p >> 3)) & 7); }

// one 16-byte piece into shared memory: asynchronous on the card (the
// kernel waits for a stage's group of copies before a barrier), a copy on
// the host
LF_DEV void copy16(long long* dst, const long long* src) {
#ifdef __CUDACC__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((u32)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 16);
#endif
}

// a += b for the fields' accumulators, as wide integers (every Acc is a
// struct of u64 words, least significant first)
template <class Acc>
LF_DEV void acc_add(Acc& a, const Acc& b) {
  constexpr int W = sizeof(Acc) / 8;
  u64* x = reinterpret_cast<u64*>(&a);
  const u64* y = reinterpret_cast<const u64*>(&b);
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const u64 s = x[i] + y[i];
    u64 c1 = s < y[i] ? 1ull : 0ull;
    x[i] = s + c;
    c1 += x[i] < c ? 1ull : 0ull;  // at most one of the two carries is set
    c = c1;
  }
}

// Lazy sums of exact products, in the forms the card's carry chains add
// cheapest; `lazy_acc` turns one into the field's Acc (the same integer)
// before the lanes' tree. Each keeps the headroom of the field's Acc for
// the sums the paths take (at most 2^20 products).
//
// F32: the field's own Acc (a 64-bit product into 128 bits).
template <class F>
struct Lazy {
  typedef typename F::Acc T;
  LF_DEV static void zero(T& a) { F::zero(a); }
  LF_DEV static void mac(T& a, const typename F::Elem& x, const typename F::Elem& y) { F::mac(a, x, y); }
  LF_DEV static void acc(const T& a, typename F::Acc& out) { out = a; }
};

// F64: x y = x0 y0 + (x0 y1 + x1 y0) 2^32 + x1 y1 2^64 (32-bit halves) as
// two independent chains of 32-bit multiply-adds with carries: u (160 bits)
// takes x0 y0 + x1 y1 2^64, m (96 bits) the cross products; the value is
// u + m 2^32. 11 instructions, 8 of them multiply-adds.
struct Lazy64 {
  u32 u[5], m[3];
};
template <>
struct Lazy<F64> {
  typedef Lazy64 T;
  LF_DEV static void zero(T& a) {
#pragma unroll
    for (int i = 0; i < 5; ++i) a.u[i] = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) a.m[i] = 0;
  }
  LF_DEV static void mac(T& a, u64 x, u64 y) {
    const u32 x0 = (u32)x, x1 = (u32)(x >> 32), y0 = (u32)y, y1 = (u32)(y >> 32);
#ifdef __CUDACC__
    asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %8, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(a.u[0]), "+r"(a.u[1]), "+r"(a.u[2]), "+r"(a.u[3]), "+r"(a.u[4])
        : "r"(x0), "r"(x1), "r"(y0), "r"(y1));
    asm("mad.lo.cc.u32 %0, %3, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %6, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "mad.lo.cc.u32 %0, %4, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %4, %5, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(a.m[0]), "+r"(a.m[1]), "+r"(a.m[2])
        : "r"(x0), "r"(x1), "r"(y0), "r"(y1));
#else
    const u64 p00 = (u64)x0 * y0, p11 = (u64)x1 * y1, p01 = (u64)x0 * y1, p10 = (u64)x1 * y0;
    const u32 add_u[4] = {(u32)p00, (u32)(p00 >> 32), (u32)p11, (u32)(p11 >> 32)};
    u64 c = 0;
    for (int i = 0; i < 4; ++i) {
      c += (u64)a.u[i] + add_u[i];
      a.u[i] = (u32)c;
      c >>= 32;
    }
    a.u[4] += (u32)c;
    const u64 cross[2] = {p01, p10};
    for (const u64 p : cross) {
      c = (u64)a.m[0] + (u32)p;
      a.m[0] = (u32)c;
      c = (c >> 32) + a.m[1] + (p >> 32);
      a.m[1] = (u32)c;
      a.m[2] += (u32)(c >> 32);
    }
#endif
  }
  LF_DEV static void acc(const T& a, F64::Acc& out) {
    out.w0 = (u64)a.u[0] | ((u64)a.u[1] << 32);
    out.w1 = (u64)a.u[2] | ((u64)a.u[3] << 32);
    out.w2 = a.u[4];
    const F64::Acc mid = {(u64)a.m[0] << 32, (u64)a.m[1] | ((u64)a.m[2] << 32), 0};
    acc_add(out, mid);
  }
};

// F256: x y by rows of 32-bit limbs: row i adds x_i y_j's low halves into
// words i .. i + 7 and its high halves into words i + 1 .. i + 8, each as
// one carry chain; the carry out of each chain's last word is counted in
// k (k[w]: carries into word w, w = 9 .. 17) instead of rippling on. 20
// instructions a row, 16 of them multiply-adds.
struct Lazy256 {
  u32 a[17], k[9];
};
template <>
struct Lazy<F256> {
  typedef Lazy256 T;
  LF_DEV static void zero(T& v) {
#pragma unroll
    for (int i = 0; i < 17; ++i) v.a[i] = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) v.k[i] = 0;
  }
  LF_DEV static void mac(T& v, const U256& x, const U256& y) {
    u32 yw[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yw[2 * j] = (u32)y.w[j];
      yw[2 * j + 1] = (u32)(y.w[j] >> 32);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const u32 xi = (u32)(x.w[i / 2] >> (32 * (i % 2)));
      u32* a = v.a + i;
#ifdef __CUDACC__
      asm("mad.lo.cc.u32 %0, %12, %13, %0;\n\t"
          "madc.lo.cc.u32 %1, %12, %14, %1;\n\t"
          "madc.lo.cc.u32 %2, %12, %15, %2;\n\t"
          "madc.lo.cc.u32 %3, %12, %16, %3;\n\t"
          "madc.lo.cc.u32 %4, %12, %17, %4;\n\t"
          "madc.lo.cc.u32 %5, %12, %18, %5;\n\t"
          "madc.lo.cc.u32 %6, %12, %19, %6;\n\t"
          "madc.lo.cc.u32 %7, %12, %20, %7;\n\t"
          "addc.cc.u32 %8, %8, 0;\n\t"
          "addc.u32 %9, %9, 0;\n\t"
          "mad.hi.cc.u32 %1, %12, %13, %1;\n\t"
          "madc.hi.cc.u32 %2, %12, %14, %2;\n\t"
          "madc.hi.cc.u32 %3, %12, %15, %3;\n\t"
          "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
          "madc.hi.cc.u32 %5, %12, %17, %5;\n\t"
          "madc.hi.cc.u32 %6, %12, %18, %6;\n\t"
          "madc.hi.cc.u32 %7, %12, %19, %7;\n\t"
          "madc.hi.cc.u32 %8, %12, %20, %8;\n\t"
          "addc.cc.u32 %10, %10, 0;\n\t"
          "addc.u32 %11, %11, 0;"
          : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+r"(a[4]), "+r"(a[5]), "+r"(a[6]), "+r"(a[7]),
            "+r"(a[8]), "+r"(v.k[i]), "+r"(a[9]), "+r"(v.k[i + 1])
          : "r"(xi), "r"(yw[0]), "r"(yw[1]), "r"(yw[2]), "r"(yw[3]), "r"(yw[4]), "r"(yw[5]), "r"(yw[6]),
            "r"(yw[7]));
#else
      u64 c = 0;
      for (int j = 0; j < 8; ++j) {
        c += (u64)a[j] + (u32)((u64)xi * yw[j]);
        a[j] = (u32)c;
        c >>= 32;
      }
      c += a[8];
      a[8] = (u32)c;
      v.k[i] += (u32)(c >> 32);
      c = 0;
      for (int j = 0; j < 8; ++j) {
        c += (u64)a[j + 1] + (u32)(((u64)xi * yw[j]) >> 32);
        a[j + 1] = (u32)c;
        c >>= 32;
      }
      c += a[9];
      a[9] = (u32)c;
      v.k[i + 1] += (u32)(c >> 32);
#endif
    }
  }
  LF_DEV static void acc(const T& v, F256::Acc& out) {
    u64 c = 0;
#pragma unroll
    for (int w = 0; w < 18; ++w) {  // word w: a[w] + k[w - 9], carried on
      c += (w < 17 ? (u64)v.a[w] : 0ull) + (w >= 9 ? (u64)v.k[w - 9] : 0ull);
      const u32 lo = (u32)c;
      c >>= 32;
      if (w % 2 == 0)
        out.w[w / 2] = lo;
      else
        out.w[w / 2] |= (u64)lo << 32;
    }
  }
};

// two int64 lanes of shared memory (16 bytes, aligned) as (lo, hi) limbs
LF_DEV u64 lds_pair(const long long* p) {
#ifdef __CUDACC__
  u64 x, y;
  asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];\n" : "=l"(x), "=l"(y) : "r"((u32)__cvta_generic_to_shared(p)));
  return x | (y << 32);
#else
  return (u64)p[0] | ((u64)p[1] << 32);
#endif
}

// two int64 lanes of device memory (16 bytes, aligned, read-only while the
// kernel runs) as (lo, hi) limbs, not kept in L1: each is read once
LF_DEV u64 ldg_pair(const long long* p) {
#ifdef __CUDACC__
  u64 x, y;
  asm("ld.global.nc.L1::no_allocate.v2.u64 {%0, %1}, [%2];\n" : "=l"(x), "=l"(y) : "l"(p));
  return x | (y << 32);
#else
  return (u64)p[0] | ((u64)p[1] << 32);
#endif
}

// the launch's arguments
struct Problem {
  const long long* A;    // [kappa, n, ncomp, e, nl]
  const long long* f;    // [n, Nb, ncomp, e, nl]
  const long long* red;  // [e - 1, e, nl] Montgomery limbs of y^(e+k) mod m(y)
  u64* partial;          // [nchunks, ncomp, kappa Nb, 2e - 1, W]
  long long* out;        // [kappa, Nb, ncomp, e, nl]
  int kappa, n, Nb, ncomp;
  int kg, bg;    // tiles of a pair group along k and along b
  int lanes;     // L: the lanes of an item
  int tn;        // TN: n rows a stage
  int chunk, nchunks;
  int fwarps;    // pass 2: warps an output (1, 2, 4 or 8)
};

// the tiles along k and b, the groups along k, and all groups
template <int KT, int BT>
LF_CM_HD int k_tiles(const Problem& pr) { return (pr.kappa + KT - 1) / KT; }
template <int KT, int BT>
LF_CM_HD int b_tiles(const Problem& pr) { return (pr.Nb + BT - 1) / BT; }
template <int KT, int BT>
LF_CM_HD int k_groups(const Problem& pr) { return (k_tiles<KT, BT>(pr) + pr.kg - 1) / pr.kg; }
template <int KT, int BT>
LF_CM_HD int groups(const Problem& pr) {
  return k_groups<KT, BT>(pr) * ((b_tiles<KT, BT>(pr) + pr.bg - 1) / pr.bg);
}

template <class F, int E, int KT, int BT, bool DF>
struct Block {
  typedef typename F::Elem Elem;
  typedef typename F::Acc Acc;
  static constexpr int NL = F::NL;
  static constexpr int S = 2 * E - 1;
  static constexpr int W = sizeof(Acc) / 8;
  static constexpr int NC = ncomp_of(NL, E);
  static constexpr int PR = row_pieces(NC, E, NL);  // pieces a row
  static constexpr int PP = pitch_pieces(PR);       // a staged row's pitch in pieces
  static constexpr int ROW = 2 * PR;                // int64 lanes a row
  // a warp stages RPW rows at a time: lane l copies piece l % PR of row
  // l / PR (Frog's rows are 16 pieces, so two a warp), or pieces l, l + 32
  static constexpr int RPW = PR <= WARP ? WARP / PR : 1;

  typedef Lazy<F> LZ;
  // a thread's sums: the S coefficients of each of its pairs, lazy while
  // it multiplies (Regs), then as the field's Acc for the lanes' tree and
  // the store (Sums)
  struct Regs {
    typename LZ::T acc[KT][BT][S];
  };
  struct Sums {
    Acc acc[KT][BT][S];
  };

  static LF_CM_HD int threads(const Problem& pr) {
    return (pr.lanes * NC * pr.kg * pr.bg + WARP - 1) / WARP * WARP;
  }
  static LF_CM_HD size_t smem_bytes(const Problem& pr) {
    return 2 * (size_t)(pr.kg * KT + (DF ? 0 : pr.bg * BT)) * pr.tn * PP * 16;
  }

  Problem pr;
  int ch, n0, n1;        // the chunk and its n
  int k0, krows, b0, brows;  // the group's first k and b and its rows of A and f
  int KS, BS;            // staged slots of A and of f (kg KT, bg BT)
  long long* sm;         // the two stage buffers

  LF_DEV Block(const Problem& pr_, int group, int chunk_index, unsigned char* smem) : pr(pr_), ch(chunk_index) {
    const int kgs = k_groups<KT, BT>(pr);
    const int ki = group % kgs, bi = group / kgs;
    KS = pr.kg * KT;
    BS = pr.bg * BT;
    k0 = ki * KS;
    krows = pr.kappa - k0 < KS ? pr.kappa - k0 : KS;
    b0 = bi * BS;
    brows = pr.Nb - b0 < BS ? pr.Nb - b0 : BS;
    n0 = ch * pr.chunk;
    n1 = pr.n < n0 + pr.chunk ? pr.n : n0 + pr.chunk;
    sm = reinterpret_cast<long long*>(smem);
  }

  LF_DEV int stages() const { return n1 > n0 ? (n1 - n0 + pr.tn - 1) / pr.tn : 0; }
  LF_DEV int stage_rows(int t) const {
    const int nt = n0 + t * pr.tn;
    return n1 - nt < pr.tn ? n1 - nt : pr.tn;
  }
  // the staged slots of an n-row: the group's KS slots of A (k0 + s) and,
  // unless f is read directly (DF), its BS slots of f (b0 + s - KS)
  LF_DEV int slots() const { return DF ? KS : KS + BS; }
  // the first lane of buffer `buf`, and of its staged row of slot s at
  // n-row j
  LF_DEV long long* buffer(int buf) const { return sm + (size_t)buf * slots() * pr.tn * PP * 2; }
  LF_DEV int row(int j, int s) const { return (j * slots() + s) * PP * 2; }

  // thread -> (lane, component, tile along k, tile along b); a thread past
  // the last item is idle in the sums (it still stages and shuffles)
  LF_DEV bool coords(int tid, int& lane, int& c, int& tk, int& tb) const {
    lane = tid % pr.lanes;
    const int item = tid / pr.lanes;
    c = item % NC;
    const int tile = item / NC;
    tk = tile % pr.kg;
    tb = tile / pr.kg;
    return tile < pr.kg * pr.bg;
  }

  // stage t of the chunk into buffer buf: its n-rows' slots (j, s) walked
  // in order, a warp a row (or RPW rows), a lane a 16-byte piece,
  // consecutive lanes on consecutive pieces; slots past the group's last k
  // or b are skipped
  LF_DEV void stage(int buf, int t, int tid, int nth) const {
    const int nt = n0 + t * pr.tn, tl = stage_rows(t), ns = slots();
    long long* base = buffer(buf);
    const int lane = tid % WARP, sub = PR <= WARP ? lane / PR : 0, p0 = PR <= WARP ? lane % PR : lane;
    if (sub >= RPW) return;  // Goldilocks' lanes 24-31
    const int r0 = tid / WARP * RPW + sub, step = nth / WARP * RPW, dj = step / ns, ds = step % ns;
    for (int j = r0 / ns, s = r0 % ns; j < tl;) {
      const bool is_a = s < KS;
      if (is_a ? s < krows : s - KS < brows) {
        const long long* src = is_a ? pr.A + ((size_t)(k0 + s) * pr.n + nt + j) * ROW
                                    : pr.f + ((size_t)(nt + j) * pr.Nb + b0 + s - KS) * ROW;
        long long* dst = base + row(j, s);
#pragma unroll
        for (int p = p0; p < PR; p += WARP) copy16(dst + 2 * swz(j, p), src + 2 * p);
      }
      j += dj;
      s += ds;
      if (s >= ns) {
        s -= ns;
        ++j;
      }
    }
  }

  // F_q value q (= c e + i) of a staged row at n-row j
  LF_DEV Elem load(const long long* row, int j, int q) const {
    if constexpr (NL == 1) {
      return (Elem)row[2 * swz(j, q >> 1) + (q & 1)];
    } else if constexpr (NL == 2) {
      return lds_pair(row + 2 * swz(j, q));
    } else {
      Elem v;
#pragma unroll
      for (int h = 0; h < 4; ++h) v.w[h] = lds_pair(row + 2 * swz(j, 4 * q + h));
      return v;
    }
  }

  // F_q value q (= c e + i) of a row of A or f in device memory
  LF_DEV static Elem load_global(const long long* row, int q) {
    if constexpr (NL == 1) {
#ifdef __CUDACC__
      return (Elem)__ldg(row + q);
#else
      return (Elem)row[q];
#endif
    } else if constexpr (NL == 2) {
      return ldg_pair(row + 2 * q);
    } else {
      Elem v;
#pragma unroll
      for (int h = 0; h < 4; ++h) v.w[h] = ldg_pair(row + 8 * q + 2 * h);
      return v;
    }
  }

  LF_DEV static void zero(Regs& r) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
#pragma unroll
        for (int s = 0; s < S; ++s) LZ::zero(r.acc[kk][bb][s]);
  }
  LF_DEV static void sums(const Regs& r, Sums& out) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
#pragma unroll
        for (int s = 0; s < S; ++s) LZ::acc(r.acc[kk][bb][s], out.acc[kk][bb][s]);
  }

  // rows of f a thread loads from device memory before their products (DF)
  static constexpr int RB = 4;

  // the thread's rows j = lane, lane + L, ... of stage t (in buffer buf):
  // every product of its KT A values and BT f values, e^2 a pair. With DF
  // (one tile along k: each f value has one reader) the f values come from
  // device memory, RB rows at a time, else from the staged slots
  LF_DEV void mac_rows(int buf, int t, int tid, Regs& r) const {
    int lane, c, tk, tb;
    if (!coords(tid, lane, c, tk, tb)) return;
    const long long* base = buffer(buf);
    const int tl = stage_rows(t), L = pr.lanes;
    if constexpr (DF) {
      const int nt = n0 + t * pr.tn;
      for (int j0 = lane; j0 < tl; j0 += RB * L) {
        Elem w[RB][BT][E];
#pragma unroll
        for (int q = 0; q < RB; ++q)
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
            const int j = j0 + q * L, bl = tb * BT + bb;
            const long long* frow = pr.f + ((size_t)(nt + j) * pr.Nb + b0 + bl) * ROW;
#pragma unroll
            for (int i = 0; i < E; ++i) w[q][bb][i] = j < tl && bl < brows ? load_global(frow, c * E + i) : Elem{};
          }
#pragma unroll
        for (int q = 0; q < RB; ++q)
          if (j0 + q * L < tl) products(base, j0 + q * L, c, tk, w[q], r);
      }
    } else {
      for (int j = lane; j < tl; j += L) {
        Elem w[BT][E];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
#pragma unroll
          for (int i = 0; i < E; ++i) w[bb][i] = load(base + row(j, KS + tb * BT + bb), j, c * E + i);
        products(base, j, c, tk, w, r);
      }
    }
  }

  // n-row j's products: the thread's KT staged A values times its BT f values
  LF_DEV void products(const long long* base, int j, int c, int tk, const Elem (&w)[BT][E], Regs& r) const {
    Elem a[KT][E];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int i = 0; i < E; ++i) a[kk][i] = load(base + row(j, tk * KT + kk), j, c * E + i);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb)
#pragma unroll
        for (int i = 0; i < E; ++i)
#pragma unroll
          for (int u = 0; u < E; ++u) LZ::mac(r.acc[kk][bb][i + u], a[kk][i], w[bb][u]);
  }

  // after the lanes' tree: lane 0 of an item writes its pairs' accumulators
  // (the slots past the group's last k or b hold sums of unstaged words and
  // are not written)
  LF_DEV void write_partial(int tid, const Sums& r) const {
    int lane, c, tk, tb;
    if (!coords(tid, lane, c, tk, tb) || lane != 0) return;
    const int P = pr.kappa * pr.Nb;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const int kl = tk * KT + kk, bl = tb * BT + bb;
        if (kl >= krows || bl >= brows) continue;
        u64* dst = pr.partial + (((size_t)ch * NC + c) * P + (size_t)(k0 + kl) * pr.Nb + b0 + bl) * S * W;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const u64* x = reinterpret_cast<const u64*>(&r.acc[kk][bb][s]);
#pragma unroll
          for (int w = 0; w < W; ++w) dst[s * W + w] = x[w];
        }
      }
  }
};

// pass 2: the block of output (c, p), p = k Nb + b
template <class F, int E>
struct Finish {
  typedef typename F::Elem Elem;
  typedef typename F::Acc Acc;
  static constexpr int NL = F::NL;
  static constexpr int S = 2 * E - 1;
  static constexpr int W = sizeof(Acc) / 8;

  Problem pr;

  LF_CM_HD static int outputs(const Problem& pr) { return pr.ncomp * pr.kappa * pr.Nb; }
  LF_CM_HD static int blocks(const Problem& pr) {
    const int per_block = FINISH_THREADS / WARP / pr.fwarps;
    return (outputs(pr) + per_block - 1) / per_block;
  }
  // warp -> its output (c, p) and its place among the output's fwarps
  // warps; false past the last output
  LF_DEV static bool coords(const Problem& pr, int block, int warp, int& c, int& p, int& sub) {
    const int per_block = FINISH_THREADS / WARP / pr.fwarps, P = pr.kappa * pr.Nb;
    const int o = block * per_block + warp / pr.fwarps;
    sub = warp % pr.fwarps;
    c = o / P;
    p = o % P;
    return o < outputs(pr);
  }

  // thread tid's sum of the partials of chunks tid, tid + nth, ...
  LF_DEV void chunk_sum(int c, int p, int tid, int nth, Acc (&acc)[S]) const {
    const int P = pr.kappa * pr.Nb;
#pragma unroll
    for (int s = 0; s < S; ++s) F::zero(acc[s]);
#pragma unroll 2
    for (int ch = tid; ch < pr.nchunks; ch += nth) {
      const u64* src = pr.partial + (((size_t)ch * pr.ncomp + c) * P + p) * S * W;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        Acc x;
        u64* xw = reinterpret_cast<u64*>(&x);
#pragma unroll
        for (int w = 0; w < W; ++w) xw[w] = src[s * W + w];
        acc_add(acc[s], x);
      }
    }
  }

  // output coordinate t from v_t (in o) and the high coefficients:
  // o + sum_k v_(e+k) red[k][t]
  LF_DEV Elem fold(const F& f, Elem o, const Elem (&v)[S], int t) const {
#pragma unroll
    for (int k = 0; k < E - 1; ++k) o = f.add(o, f.mul(v[E + k], F::load(pr.red + NL * (k * E + t))));
    return o;
  }

  LF_DEV void store(int c, int p, int t, const Elem& o) const {
    const int k = p / pr.Nb, b = p % pr.Nb;
    F::store(pr.out + (size_t)NL * ((((size_t)k * pr.Nb + b) * pr.ncomp + c) * E + t), o);
  }
};

}  // namespace cm90
