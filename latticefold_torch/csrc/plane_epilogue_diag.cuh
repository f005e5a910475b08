// The block algorithm of kernel B on diagonals (plane_epilogue_diag_kernel.cu):
// the index maps from a block, a warp and a lane to the words of P they
// stage and read, and the phases of a block, each run by every thread of
// its block (or warp) between barriers and reading only what an earlier
// phase wrote.
//
// P [nsl, c, M, 4 L] holds kernel A's signed plane products: row
// (k e + i) DA + ia is byte ia (limb 4 + byte, DA = 4 nl) of Ajtai row
// block k e + i, column (jb & 3) L + o nl + (jb >> 2) is byte jb (limb 4 +
// byte) of witness output o = j Nb + b, and row `rows` holds the witness
// column sums cs. A patch is the DA x DA plane products of one (i, o); its
// byte-position sums, summed over the slices, are
//   u[s] = sum over ia + jb = s of (P + 128 cs[jb] + 128 sM[ia] + 128^2 ks),
// s < 2 DA - 1.
//
// A block owns (k, c) and nB = nbb G consecutive b (G = 32 / DA): the
// e e nB patches of every (i, j) that the extension fold of its outputs
// needs. A warp task is G patches of one (i, j) and consecutive b; lane
// g DA + s walks a wrapped diagonal of patch g: at step m it reads row
// byte ia = m and column byte jb = (s - m) mod DA, corrects the word with
// cs[jb] and sM[ia], and adds it to position s when m <= s, else to s + DA
// (the plane of step m is that of step m mod 4, so a lane finds its four
// plane offsets once). At each step a warp reads one row of each of its
// patches, the G nl = 8 consecutive words of each byte plane: a whole
// 32-byte sector of each plane.
//
// At nl 8 (staged mode) the block first stages, per slice, for each of its
// e DA rows and the colsum row, each byte plane and each j, the run of
// nB nl words of its b in shared memory, in 16-byte pieces (a run starts at
// a multiple of 8 words, and rows are 16 L bytes apart), and its rows' sM;
// the plane slots are 8 mod 32 words apart, so the four planes of a step
// fall in distinct banks. At nl 1 and 2 (direct mode) a lane loads its
// DA words and their cs and sM from device memory at once (`load`).
//
// Then a thread per patch finishes it (the limb-at-a-time carry and the
// wide reduction of plane_epilogue.cuh, to P_ij; for e = 1 the output),
// and for e > 1 a thread per (b, t) folds: conv_t + sum_k conv_(e+k)
// red[k][t], conv_s = sum_(i+j=s) P_ij, with the field's add and
// Montgomery mul.
//
// Like the field headers it compiles as plain C++ too (field_common.cuh),
// so tests/test_torch_csrc_epilogue_tile.py runs every block of a grid
// with g++, a phase at a time over the threads, and holds it against the
// plain epilogue.

#pragma once

#include <cstddef>

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"
#include "plane_epilogue.cuh"

#ifdef __CUDACC__
// each word of P that a lane reads directly is read once: stream it
#define LF_LD_STREAM(p) __ldcs(p)
#define LF_HD __host__ __device__ __forceinline__
#define LF_HDC __host__ __device__ constexpr
#else
#include <cstring>
#define LF_LD_STREAM(p) (*(p))
#define LF_HD inline
#define LF_HDC constexpr
#endif

namespace epi_diag {

constexpr int WARP = 32;

// the most warps of a block: at nl 2 one a warp task of a b group (e e),
// at nl 1 16 (81 warp tasks a b group, fewer blocks than SMs), at nl 8 8
LF_HDC int max_warps(int nl, int e) { return nl == 2 ? e * e : nl == 1 ? 16 : 8; }

// whether a lane reads its words of P from device memory directly (else
// from the block's staged tile): at nl 1 and 2 a block's tile is a few KB
// and staging it first only adds a round trip and a barrier; at nl 8 the
// staged tile is faster (PERF.md, section 6)
LF_HDC bool direct(int nl) { return nl <= 2; }

// one 16-byte piece of P into shared memory: asynchronous on the card (the
// kernel waits for all of them before a barrier), a copy on the host
LF_DEV void copy16(int* dst, const int* src) {
#ifdef __CUDACC__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((u32)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 16);
#endif
}

// P's row of byte ia of Ajtai row block k e + i
LF_HD int p_row(int da, int e, int k, int i, int ia) { return (k * e + i) * da + ia; }

// P's column of byte jb (limb 4 + byte) of witness output o
LF_HD int p_col(int L, int nl, int o, int jb) { return (jb & 3) * L + o * nl + (jb >> 2); }

// the column byte that the lane of diagonal s reads at step m (row byte
// ia = m), and the position that word adds to
LF_HD int diag_jb(int da, int s, int m) { return (s - m) & (da - 1); }
LF_HD int diag_pos(int da, int s, int m) { return m <= s ? s : s + da; }

// warp task -> (i, j, b group) of its patches
LF_HD void task_coords(int e, int nbb, int task, int& i, int& j, int& bg) {
  bg = task % nbb;
  j = (task / nbb) % e;
  i = task / (nbb * e);
}

// lane -> (its patch in the task, its diagonal)
LF_HD int lane_patch(int da, int lane) { return lane / da; }
LF_HD int lane_diag(int da, int lane) { return lane % da; }

// the block's patch (bl = b - b_lo, i, j): where its position sums and its
// P_ij lie
LF_HD int patch_index(int e, int bl, int i, int j) { return (bl * e + i) * e + j; }

// the output limbs of (k, b, c, t): out [kappa, Nb, c, e, nl]
LF_HD long long out_index(int Nb, int ncomp, int e, int nl, int k, int b, int c, int t) {
  return (long long)nl * ((((long long)k * Nb + b) * ncomp + c) * e + t);
}

// the staged words (staged mode): a slot of `seg` = nB nl words per (row,
// plane, j), holding the block's run of P, the planes' slots `pitch` words
// apart (8 mod 32)
LF_HD int plane_pitch(int e, int seg) { return (e * seg + 23) / 32 * 32 + 8; }
LF_HD int tile_index(int pitch, int seg, int nl, int rowl, int jb, int j, int bl) {
  return (rowl * 4 + (jb & 3)) * pitch + j * seg + bl * nl + (jb >> 2);
}

// staging piece -> (row, plane, j, 16-byte piece q of the run)
LF_HD void piece_coords(int e, int quads, int idx, int& rowl, int& plane, int& j, int& q) {
  q = idx % quads;
  j = (idx / quads) % e;
  plane = (idx / (quads * e)) % 4;
  rowl = idx / (quads * e * 4);
}

// the launch's arguments
struct Problem {
  const int* P;           // [nsl, c, M, 4 L] int32
  const int* sM;          // [c, nsl, M] int32
  const long long* red;   // [e - 1, e, nl] Montgomery limbs of y^(e+k) mod m(y)
  long long* out;         // [kappa, Nb, c, e, nl]
  int nsl, ncomp, M, L, rows, Nb, n, kslice, nbb;
};

template <class F, int E>
struct Block {
  typedef typename F::Elem Elem;
  static constexpr int NL = F::NL;
  static constexpr int DA = 4 * NL;       // the bytes of a limb row and of a limb column
  static constexpr int S = 2 * DA - 1;    // byte positions of a patch
  static constexpr int G = WARP / DA;     // patches of a warp task
  static constexpr int UP = 2 * DA + 1;   // u64 words between patches' sums (odd: spread banks)
  static constexpr bool DIRECT = direct(NL);
  static constexpr int ROWS = DIRECT ? 0 : E * DA + 1;  // staged rows: the block's and the colsum row
  static constexpr int RED = (E - 1) * E * NL;  // limbs of red
  static_assert(WARP % DA == 0, "a warp holds whole patches");
  static_assert(DIRECT || NL % 4 == 0, "staged runs start 16-byte aligned");

  Problem pr;
  int k, c, b_lo, nbv, nB, patches, tasks, seg, pitch;
  int* tile;        // [ROWS][4][pitch] the slice's staged words
  int* sm;          // [E DA] the slice's sM of the block's rows
  u64* U;           // [patches][UP] position sums
  long long* rs;    // [RED] red (e > 1)
  Elem* pv;         // [patches] P_ij (e > 1)

  static LF_HD int b_per_block(int nbb) { return nbb * G; }
  static LF_HD int warps_per_block(int nbb, int max_warps) {
    const int t = E * E * nbb;
    return t < max_warps ? t : max_warps;
  }
  static LF_HD size_t smem_bytes(int nbb) {
    const int nb = b_per_block(nbb), p = nb * E * E;
    return ((size_t)ROWS * 4 * plane_pitch(E, nb * NL) + E * DA + 2) / 2 * 2 * sizeof(int) +
           (size_t)p * UP * sizeof(u64) + (E > 1 ? (size_t)RED * sizeof(long long) + (size_t)p * sizeof(Elem) : 0);
  }

  LF_DEV Block(const Problem& pr_, int k_, int c_, int z, unsigned char* smem) : pr(pr_), k(k_), c(c_) {
    nB = b_per_block(pr.nbb);
    b_lo = z * nB;
    nbv = pr.Nb - b_lo < nB ? pr.Nb - b_lo : nB;
    patches = nB * E * E;
    tasks = E * E * pr.nbb;
    seg = nB * NL;
    pitch = plane_pitch(E, seg);
    tile = reinterpret_cast<int*>(smem);
    sm = tile + ROWS * 4 * pitch;
    U = reinterpret_cast<u64*>(sm + (E * DA + 2) / 2 * 2);
    rs = reinterpret_cast<long long*>(U + (size_t)patches * UP);
    pv = reinterpret_cast<Elem*>(rs + RED);
  }

  // the word (of a row) where the block's run of (plane, j) starts: in
  // staged mode (nl 8) a multiple of 8, and rows are 16 L bytes apart, so
  // every run starts 16-byte aligned
  LF_DEV int run(int plane, int j) const { return p_col(pr.L, NL, j * pr.Nb + b_lo, plane); }

  // the block's copy of red, for the fold (e > 1)
  LF_DEV void prologue(int tid, int nth) const {
    for (int x = tid; x < RED; x += nth) rs[x] = pr.red[x];
  }

  // staged mode: the slice's runs of the block's rows and of the colsum
  // row, and its sM
  LF_DEV void stage(int si, int tid, int nth) const {
    const long long N = 4LL * pr.L;
    const int* Pc = pr.P + ((long long)si * pr.ncomp + c) * pr.M * N;
    const int quads = seg / 4;
    for (int idx = tid; idx < ROWS * 4 * E * quads; idx += nth) {
      int rowl, plane, j, q;
      piece_coords(E, quads, idx, rowl, plane, j, q);
      if (4 * q >= nbv * NL) continue;  // past the last b
      const int grow = rowl < E * DA ? p_row(DA, E, k, rowl / DA, rowl % DA) : pr.rows;
      copy16(tile + (rowl * 4 + plane) * pitch + j * seg + 4 * q, Pc + grow * N + run(plane, j) + 4 * q);
    }
    const int* sMc = pr.sM + ((long long)c * pr.nsl + si) * pr.M;
    for (int x = tid; x < (DIRECT ? 0 : E * DA); x += nth) sm[x] = sMc[p_row(DA, E, k, x / DA, x % DA)];
  }

  // direct mode: a lane's words of P of a task and their corrections, read
  // from device memory (word m: row byte ia = m, column byte jb = (s - m)
  // mod DA; cs[jb] + sM[ia] beside it)
  struct Words {
    int v[DA];  // P
    int x[DA];  // cs[jb] + sM[ia] of the same word
  };
  LF_DEV Words load(int si, int task, int tid) const {
    Words w;
    const int lane = tid % WARP;
    int i, j, bg;
    task_coords(E, pr.nbb, task, i, j, bg);
    const int bl = bg * G + lane_patch(DA, lane), s = lane_diag(DA, lane);
    if (b_lo + bl >= pr.Nb) return w;
    const long long N = 4LL * pr.L;
    const int* prow = pr.P + ((long long)si * pr.ncomp + c) * pr.M * N + (long long)p_row(DA, E, k, i, 0) * N;
    int qg[4];  // P's column of the word of step r, w 0: the plane of step m is that of step m mod 4
#pragma unroll
    for (int r = 0; r < 4; ++r) qg[r] = p_col(pr.L, NL, j * pr.Nb + b_lo + bl, diag_jb(DA, s, r) & 3);
#pragma unroll
    for (int m = 0; m < DA; ++m) w.v[m] = LF_LD_STREAM(prow + m * N + qg[m & 3] + (diag_jb(DA, s, m) >> 2));
    const int* Pc = pr.P + ((long long)si * pr.ncomp + c) * pr.M * N;
    const int* sMr = pr.sM + ((long long)c * pr.nsl + si) * pr.M + p_row(DA, E, k, i, 0);
#pragma unroll
    for (int m = 0; m < DA; ++m) w.x[m] = Pc[pr.rows * N + qg[m & 3] + (diag_jb(DA, s, m) >> 2)] + sMr[m];
    return w;
  }

  // a lane's diagonal of the slice (its words `wd` in direct mode, else
  // the staged ones): the words, corrected with colsum and sM, added into
  // its two position sums
  LF_DEV void group(int si, int task, int tid, const Words& wd) const {
    const int lane = tid % WARP;
    int i, j, bg;
    task_coords(E, pr.nbb, task, i, j, bg);
    const int bl = bg * G + lane_patch(DA, lane), s = lane_diag(DA, lane);
    if (b_lo + bl >= pr.Nb) return;
    const int ks = (pr.n < (si + 1) * pr.kslice ? pr.n : (si + 1) * pr.kslice) - si * pr.kslice;
    const u32 K = 16384u * (u32)ks;
    // the offset in a staged row of the word of column byte jb = (s - r)
    // mod 4 + 4 w at w = 0: the plane of step m is that of step m mod 4
    int qb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jb = diag_jb(DA, s, r) & 3;
      qb[r] = tile_index(pitch, seg, NL, 0, jb, j, bl);
    }
    const int* csr = tile + E * DA * 4 * pitch;
    const int* rows = tile + i * DA * 4 * pitch;
    u64 lo = 0, hi = 0;
#pragma unroll 8
    for (int m = 0; m < DA; ++m) {
      const int x = qb[m & 3] + (diag_jb(DA, s, m) >> 2);
      const int p = DIRECT ? wd.v[m] : rows[m * 4 * pitch + x];
      // P + 128 (cs + sM) + 128^2 ks: the unsigned plane product, below
      // 2^31, exact in u32 arithmetic
      const u32 v = (u32)p + ((u32)(DIRECT ? wd.x[m] : csr[x] + sm[i * DA + m]) << 7) + K;
      if (diag_pos(DA, s, m) < DA)
        lo += v;
      else
        hi += v;
    }
    u64* u = U + (size_t)patch_index(E, bl, i, j) * UP;
    if (si == 0) {
      u[s] = lo;
      u[s + DA] = hi;  // s = DA - 1: the unused word 2 DA - 1, 0
    } else {
      u[s] += lo;
      u[s + DA] += hi;
    }
  }

  // a thread per patch: its position sums -> P_ij (for e = 1 the output)
  LF_DEV void finish(int tid, int nth, const WideRedc<NL>& wr) const {
    for (int p = tid; p < patches; p += nth) {
      const int b = b_lo + p / (E * E);
      if (b >= pr.Nb) continue;
      u32 t[2 * NL + 2], o[NL];
      carry_limbs64<NL>(U + (size_t)p * UP, S, t);
      wr.reduce(t, o);
      long long lanes[NL];
#pragma unroll
      for (int x = 0; x < NL; ++x) lanes[x] = o[x];
      if (E == 1)
        F::store(pr.out + out_index(pr.Nb, pr.ncomp, E, NL, k, b, c, 0), F::load(lanes));
      else
        pv[p] = F::load(lanes);
    }
  }

  // a thread per (b, t): the extension fold, written out (e > 1)
  LF_DEV void fold(const F& f, int tid, int nth) const {
    for (int item = tid; item < nB * E; item += nth) {
      const int bl = item / E, t = item % E, b = b_lo + bl;
      if (b >= pr.Nb) continue;
      Elem conv[2 * E - 1];
      bool set[2 * E - 1];
#pragma unroll
      for (int s = 0; s < 2 * E - 1; ++s) set[s] = false;
#pragma unroll
      for (int i = 0; i < E; ++i)
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const Elem x = pv[patch_index(E, bl, i, j)];
          conv[i + j] = set[i + j] ? f.add(conv[i + j], x) : x;
          set[i + j] = true;
        }
      Elem o = conv[0];
#pragma unroll
      for (int s = 1; s < E; ++s)
        if (s == t) o = conv[s];
#pragma unroll
      for (int kk = 0; kk < E - 1; ++kk) o = f.add(o, f.mul(conv[E + kk], F::load(rs + NL * (kk * E + t))));
      F::store(pr.out + out_index(pr.Nb, pr.ncomp, E, NL, k, b, c, t), o);
    }
  }
};

}  // namespace epi_diag
