// The device transcript's Poseidon sponge for every limb width the rings
// use (nl = 1, 2, 8: one template instance per field type): the sponge
// kernel, one launch per absorb or squeeze call, and the first design, one
// launch per permutation.
//
// Replaces no Pallas kernel: the JAX package computes the permutation in
// XLA (latticefold_tpu/transcript/device.py:74 `permute`, a lax.scan over
// the rounds inside its single-dispatch provers). The port runs eagerly, and
// the permutation in torch ops is thousands of tiny launches: 30 rounds,
// each an s-box of 4 Montgomery products and a 24 x 24 MDS product, every
// Montgomery product an nl^2-step limb chain (modops.py `_mont_limbs`).
//
// What bounds it: latency. The work is a chain of 30 dependent rounds (a
// few hundred bytes in and out, some 10^4 32-bit multiply-adds), far below
// what the card's memory or integer units notice, so the launch (about 5 us)
// and the round chain's dependent products set its time.
//
// lf_poseidon_sponge, the sponge kernel (the path's): one block of three
// warps runs a whole absorb or squeeze call of TraceSponge
// (transcript/device.py), its permutations back to back with the state on
// chip: a mode switch's permutation first where the call needs one, each
// rate chunk of `vals` added before the permutation that follows it (the
// owning lane loads its word of the next chunk one permutation ahead), the
// trailing chunk added, squeezed words written out (poseidon.cuh
// `lf_sponge_call_serial` is the same schedule one word at a time).
// - Constants: the factored form's constants (poseidon.cuh; ARK, MDS, B_1 M,
//   the partial rounds' sparse matrices and the C matrix: rf t + 2 t^2 +
//   2 t rp + rp^2 = 2884 Elems, 11.5 KB at nl 1, 23.1 KB at nl 2, 92.3 KB
//   at nl 8) come into shared memory once per launch by one bulk
//   asynchronous copy behind an mbarrier, while the lanes load the state;
//   no round waits on device memory.
// - Full rounds: four lanes per state word (96 lanes for t = 24). The word's
//   first lane applies the constant and the s-box and publishes the word
//   (double-buffered by round parity, one barrier a round); each of the four
//   lanes sums t/4 products of the word's MDS row into its own lazy sum, and
//   two xor-shuffles combine the four sums before the one reduction: the
//   row's critical path is t/4 products and two additions instead of t
//   dependent accumulations, spread over three SM sub-partitions.
// - Partial rounds, factored: warp 0 alone, a lane per word. Every lane
//   runs the s-box of word 0 (no broadcast); meanwhile lanes 1 .. t-1 form
//   their product with S's row 0 and five xor-shuffles add them; then
//   word 0 is one more product and a reduction, and lane i > 0 adds
//   v_i s_0. Warps 1 and 2 wait at the barrier that ends the partial rounds.
//
// lf_poseidon, the first design (one permutation a launch, launched only by
// chip_smoke.py as the sponge kernel's in-call baseline): one block of one
// warp, a lane per state word (t = 24 of 32). The MDS matrix sits in shared
// memory transposed, so that the lanes' reads of one column fall in
// distinct banks; a round adds the lane's constant (read from global memory
// a round ahead), applies the s-box (every lane in a full round, lane 0 in a
// partial one), publishes the word to shared memory, and forms its MDS row
// as one lazy sum of exact products reduced once (csrc/poseidon.cuh).
//
// lf_poseidon_sponge:
// state  : [t, nl] int64 (u32 limbs, Montgomery form); out_state the same
// vals   : [n, nl] int64, added (absorb) or null (squeeze: out_vals [n, nl])
// consts : the factored form's Elems (cbytes bytes, a multiple of 16)
// lf_poseidon:
// state : [t, nl] int64 (u32 limbs, Montgomery form)
// chunk : [k, nl] int64, added at words off .. off + k - 1 first (k may be 0)
// ark   : [rf + rp, t, nl], mds : [t, t, nl] (Montgomery form)
// out   : [t, nl]

#include <cuda_runtime.h>

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"
#include "poseidon.cuh"
#include "sm90_async.cuh"

namespace {

constexpr int THREADS = 32;  // the first design: one warp; t <= 32
constexpr int LANES_PER_WORD = 4;  // the sponge kernel's lanes of a word in a full round
constexpr int SPONGE_THREADS = 96;  // three warps
constexpr int MAX_T = SPONGE_THREADS / LANES_PER_WORD;  // the sponge kernel's t: 24, every ring's

template <class F>
__global__ void __launch_bounds__(THREADS)
    poseidon_kernel(const long long* __restrict__ state,
                    const long long* __restrict__ chunk, int k, int off,
                    const long long* __restrict__ ark,
                    const long long* __restrict__ mds,
                    long long* __restrict__ out, int t, int rf, int rp, F f) {
  typedef typename F::Elem Elem;
  constexpr int NL = F::NL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* mds_s = reinterpret_cast<Elem*>(smem_raw);  // [t(j)][t(i)]: MDS transposed
  Elem* s_s = mds_s + t * t;                         // [t]
  const int i = threadIdx.x;

  for (int idx = i; idx < t * t; idx += THREADS) mds_s[(idx % t) * t + idx / t] = F::load(mds + NL * (size_t)idx);
  Elem x{}, a{};
  if (i < t) {
    x = F::load(state + NL * i);
    if (i >= off && i < off + k) x = f.add(x, F::load(chunk + NL * (i - off)));
    a = F::load(ark + NL * i);
  }
  __syncwarp();
  for (int r = 0; r < rf + rp; ++r) {
    if (i < t) {
      const Elem a_next = r + 1 < rf + rp ? F::load(ark + NL * (size_t)((r + 1) * t + i)) : a;
      s_s[i] = lf_round_sbox(f, x, a, lf_full_round(r, rf, rp), i);
      a = a_next;
    }
    __syncwarp();
    if (i < t) x = lf_mds_row(f, mds_s, 1, t, i, s_s, t);
    __syncwarp();
  }
  if (i < t) F::store(out + NL * i, x);
}

template <class F>
int launch(const void* state, const void* chunk, int k, int off, const void* ark, const void* mds, void* out,
           int t, int rf, int rp, const u64* consts, cudaStream_t stream) {
  const size_t smem = (size_t)(t * t + t) * sizeof(typename F::Elem);
  poseidon_kernel<F><<<1, THREADS, smem, stream>>>(
      (const long long*)state, (const long long*)chunk, k, off, (const long long*)ark, (const long long*)mds,
      (long long*)out, t, rf, rp, F::from(consts));
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// the sponge kernel
// ---------------------------------------------------------------------------

template <class Acc>
__device__ __forceinline__ Acc shfl_xor_acc(const Acc& a, int mask) {
  constexpr int W = (int)(sizeof(Acc) / sizeof(u64));
  Acc b;
  const u64* x = reinterpret_cast<const u64*>(&a);
  u64* y = reinterpret_cast<u64*>(&b);
#pragma unroll
  for (int k = 0; k < W; ++k) y[k] = __shfl_xor_sync(0xffffffffu, x[k], mask);
  return b;
}

// an Elem from lane `src` of the warp
__device__ __forceinline__ u32 shfl_elem(u32 v, int src) { return __shfl_sync(0xffffffffu, v, src); }
__device__ __forceinline__ u64 shfl_elem(u64 v, int src) { return __shfl_sync(0xffffffffu, v, src); }
__device__ __forceinline__ U256 shfl_elem(const U256& v, int src) {
  U256 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = __shfl_sync(0xffffffffu, v.w[k], src);
  return r;
}

// One permutation in the factored form, t = T words. x: this lane's word
// (row) in the full-round layout (lanes 4 row .. 4 row + 3); sbuf [2][T],
// xs [T] shared.
template <class F, int T>
__device__ __forceinline__ void permute_block(const F& f, typename F::Elem& x, const typename F::Elem* cs,
                                              typename F::Elem* sbuf, typename F::Elem* xs, int rf, int rp, int row,
                                              int g, int& par) {
  static_assert(T * LANES_PER_WORD == SPONGE_THREADS, "every lane holds a word");
  typedef typename F::Elem Elem;
  typedef typename F::Acc Acc;
  const Elem* mds = cs + lf_off_mds(T, rf);
  const Elem* pre = cs + lf_off_pre(T, rf);
  const Elem* part = cs + lf_off_part(T, rf);
  const Elem* cmat = cs + lf_off_cmat(T, rf, rp);
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < rf; ++r) {
    if (r == rf / 2) {
      // partial rounds, unrolled (poseidon.cuh): warp 0, lane j holds word
      // j's entry value, its lazy sum E_j, and (j < rp) A_j = D_j + the
      // C_jk s_k so far; every lane runs the s-box of word 0
      if (g == 0) xs[row] = x;
      sm90::named_sync<1, SPONGE_THREADS>();
      if (threadIdx.x < 32) {
        const bool word = lane >= 1 && lane < T;
        const bool acc_lane = lane < rp;
        const Elem xj = lane < T ? xs[lane] : Elem{};
        Elem x0 = xs[0];
        Elem a = acc_lane ? lf_partial_dot(f, part + 2 * T * lane, xs, T) : Elem{};  // A_lane = D_lane
        Acc e;
        F::zero(e);
        for (int k = 0; k < rp; ++k) {
          const Elem* pk = part + 2 * T * k;
          const Elem sk = lf_pow7(f, f.add(x0, pk[0]));
          const Elem y = lf_partial_word0(f, a, pk, sk);  // word 0, on lane k
          // no branch: the other lanes add products with 0
          const Elem c = acc_lane ? cmat[lane * rp + k] : Elem{};
          const Elem v = word ? pk[T + lane] : Elem{};
          a = f.add(a, f.mul(c, sk));
          F::mac(e, v, sk);
          x0 = shfl_elem(y, k);
        }
        __syncwarp();  // every lane's reads of xs are done
        if (lane < T) xs[lane] = lane == 0 ? x0 : f.add(xj, lf_reduce_fast(f, e));
      }
      sm90::named_sync<1, SPONGE_THREADS>();
      x = xs[row];
    }
    // full round: the word's four lanes run its s-box (no branch) and the
    // first publishes it; each sums a quarter of the row
    Elem* s = sbuf + par * T;
    const Elem sv = lf_pow7(f, f.add(x, cs[r * T + row]));
    if (g == 0) s[row] = sv;
    sm90::named_sync<1, SPONGE_THREADS>();
    const Elem* m = (r == rf / 2 - 1 ? pre : mds) + row * T;
    Acc acc;
    F::zero(acc);
#pragma unroll
    for (int j = 0; j < T / LANES_PER_WORD; ++j) F::mac(acc, m[g + LANES_PER_WORD * j], s[g + LANES_PER_WORD * j]);
    lf_acc_add(acc, shfl_xor_acc(acc, 1));
    lf_acc_add(acc, shfl_xor_acc(acc, 2));
    x = lf_reduce_fast(f, acc);
    par ^= 1;
  }
}

// The value index (into the call's values) of segment k for state word
// `row`, or -1 when the segment does not touch it
__device__ __forceinline__ int seg_value(int k, int nseg, int n, int idx, int rate, int cap, int row) {
  if (k >= nseg) return -1;
  int w, cnt, pos;
  lf_call_seg(k, n, idx, rate, w, cnt, pos);
  const int j = row - cap - w;
  return j >= 0 && j < cnt ? pos + j : -1;
}

template <class F, int T>
__global__ void __launch_bounds__(SPONGE_THREADS)
    poseidon_sponge_kernel(const long long* __restrict__ state, const long long* __restrict__ vals,
                           long long* __restrict__ out_vals, long long* __restrict__ out_state,
                           const void* __restrict__ consts, int cbytes, int n, int idx, int sw, int rate, int rf,
                           int rp, F f) {
  constexpr int t = T;
  typedef typename F::Elem Elem;
  constexpr int NL = F::NL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Elem* cs = reinterpret_cast<Elem*>(smem_raw);
  Elem* sbuf = reinterpret_cast<Elem*>(smem_raw + cbytes);  // [2][t]
  Elem* xs = sbuf + 2 * t;                                    // [t]
  u64* bar = reinterpret_cast<u64*>(smem_raw + ((cbytes + 3 * t * sizeof(Elem) + 15) & ~(size_t)15));
  const u32 bar_a = sm90::smem_u32(bar);
  const int row = threadIdx.x / LANES_PER_WORD, g = threadIdx.x % LANES_PER_WORD;
  const bool owner = g == 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::: "memory");
    sm90::mbar_arrive_expect_tx(bar_a, (u32)cbytes);
    sm90::bulk_load(sm90::smem_u32(cs), consts, (u32)cbytes, bar_a);
  }
  // while the constants come: the state and this word's first value
  Elem x = F::load(state + NL * row);
  const int cap = t - rate;
  const int i0 = sw ? 0 : idx;
  const int nseg = lf_call_nseg(n, i0, rate);
  int vi = vals && owner ? seg_value(0, nseg, n, i0, rate, cap, row) : -1;
  Elem v{};
  if (vi >= 0) v = F::load(vals + NL * (size_t)vi);
  __syncthreads();  // the mbarrier's init is visible
  sm90::mbar_wait(bar_a, 0);

  int par = 0;
  if (sw) permute_block<F, T>(f, x, cs, sbuf, xs, rf, rp, row, g, par);
  for (int k = 0; k < nseg; ++k) {
    if (vi >= 0) x = f.add(x, v);
    if (!vals && owner) {
      const int j = seg_value(k, nseg, n, i0, rate, cap, row);
      if (j >= 0) F::store(out_vals + NL * (size_t)j, x);
    }
    if (k + 1 < nseg) {
      vi = vals && owner ? seg_value(k + 1, nseg, n, i0, rate, cap, row) : -1;
      if (vi >= 0) v = F::load(vals + NL * (size_t)vi);
      permute_block<F, T>(f, x, cs, sbuf, xs, rf, rp, row, g, par);
    }
  }
  if (owner) F::store(out_state + NL * row, x);
}

template <class F>
int launch_sponge(const void* state, const void* vals, void* out_vals, void* out_state, const void* consts,
                  int cbytes, int n, int idx, int sw, int rate, int rf, int rp, const u64* fc, cudaStream_t stream) {
  typedef typename F::Elem Elem;
  const size_t smem = (((size_t)cbytes + 3 * MAX_T * sizeof(Elem) + 15) & ~(size_t)15) + 16;
  static size_t smem_set = 0;  // the instance's opt-in so far (each cudaFuncSetAttribute costs host time)
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(poseidon_sponge_kernel<F, MAX_T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  poseidon_sponge_kernel<F, MAX_T><<<1, SPONGE_THREADS, smem, stream>>>(
      (const long long*)state, (const long long*)vals, (long long*)out_vals, (long long*)out_state, consts, cbytes, n,
      idx, sw, rate, rf, rp, F::from(fc));
  return (int)cudaGetLastError();
}

}  // namespace

// consts: the field's u64 words (latticefold_torch/cuda.py:field_constants)
extern "C" int lf_poseidon(const void* state, const void* chunk, int k, int off, const void* ark, const void* mds,
                           void* out, int t, int rf, int rp, int nl, const u64* consts, void* stream) {
  if (t <= 0 || t > THREADS || k < 0 || (k > 0 && (off < 0 || off + k > t))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 1:
      return launch<F32>(state, chunk, k, off, ark, mds, out, t, rf, rp, consts, s);
    case 2:
      return launch<F64>(state, chunk, k, off, ark, mds, out, t, rf, rp, consts, s);
    case 8:
      return launch<F256>(state, chunk, k, off, ark, mds, out, t, rf, rp, consts, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One absorb (vals given) or squeeze (vals null, out_vals [n, nl]) call of
// n values at rate index idx, after a mode switch's permutation if sw.
// consts: the factored form's Elems (cbytes bytes); fc: the field's u64
// words (latticefold_torch/cuda.py:field_constants)
extern "C" int lf_poseidon_sponge(const void* state, const void* vals, void* out_vals, void* out_state,
                                  const void* consts, int cbytes, int n, int idx, int sw, int t, int rate, int rf,
                                  int rp, int nl, const u64* fc, void* stream) {
  const int elem = nl == 1 ? 4 : nl == 2 ? 8 : 32;
  if (t != MAX_T || rate <= 0 || rate >= t || idx < 0 || idx > rate || n < 0 || rf < 2 || rf % 2 || rp < 0 ||
      rp > 32 || cbytes % 16 || cbytes < lf_fast_elems(t, rf, rp) * elem || (!vals && n > 0 && !out_vals))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nl) {
    case 1:
      return launch_sponge<F32>(state, vals, out_vals, out_state, consts, cbytes, n, idx, sw, rate, rf, rp, fc, s);
    case 2:
      return launch_sponge<F64>(state, vals, out_vals, out_state, consts, cbytes, n, idx, sw, rate, rf, rp, fc, s);
    case 8:
      return launch_sponge<F256>(state, vals, out_vals, out_state, consts, cbytes, n, idx, sw, rate, rf, rp, fc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
