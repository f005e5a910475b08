// One Poseidon permutation of the device transcript's sponge state, with
// the rate chunk that precedes it added first, for every limb width the
// rings use (nl = 1, 2, 8: one template instance per field type).
//
// Replaces no Pallas kernel: the JAX package computes the permutation in
// XLA (latticefold_tpu/transcript/device.py:74 `permute`, a lax.scan over
// the rounds inside its single-dispatch provers). The port runs eagerly, and
// the permutation in torch ops is thousands of tiny launches: 30 rounds,
// each an s-box of 4 Montgomery products and a 24 x 24 MDS product, every
// Montgomery product an nl^2-step limb chain (modops.py `_mont_limbs`); a
// Goldilocks fold's device transcript runs about 800 permutations, so that
// would be seconds of dispatch a fold. This kernel is one launch a
// permutation.
//
// What bounds it: latency. The work is a chain of 30 dependent rounds (a
// few hundred bytes in and out, some 10^4 32-bit multiply-adds), far below
// what the card's memory or integer units notice, so the launch (about 5 us)
// and the round chain's dependent products set its time.
// Design: one block of one warp, a lane per state word (t = 24 of 32). The
// MDS matrix sits in shared memory transposed, so that the lanes' reads of
// one column fall in distinct banks; a round adds the lane's constant (read
// from global memory a round ahead), applies the s-box (every lane in a
// full round, lane 0 in a partial one), publishes the word to shared
// memory, and forms its MDS row as one lazy sum of exact products reduced
// once (csrc/poseidon.cuh).
//
// state : [t, nl] int64 (u32 limbs, Montgomery form)
// chunk : [k, nl] int64, added at words off .. off + k - 1 first (k may be 0)
// ark   : [rf + rp, t, nl], mds : [t, t, nl] (Montgomery form)
// out   : [t, nl]

#include <cuda_runtime.h>

#include "field256.cuh"
#include "field32.cuh"
#include "field64.cuh"
#include "poseidon.cuh"

namespace {

constexpr int THREADS = 32;  // one warp; t <= 32

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
