// Native Poseidon sponge for <=64-bit prime fields (Goldilocks, Frog, BabyBear).
//
// Drop-in backend for latticefold_torch.transcript.poseidon.PoseidonSponge:
// identical duplex mechanics (capacity-first state, lazy permutation), same
// round structure (R_F/2 full, R_P partial, R_F/2 full; ark added every round
// to all lanes, s-box x^alpha on all lanes in full rounds / lane 0 in partial
// rounds, dense MDS row products). The 252-bit Stark field stays on the
// Python path.
//
// Built as a shared library, loaded via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;

namespace {

struct Sponge {
  uint64_t q;
  int rate;
  int capacity;
  int t;
  int full_rounds;
  int partial_rounds;
  uint64_t alpha;
  std::vector<uint64_t> ark;  // (full+partial) x t
  std::vector<uint64_t> mds;  // t x t
  std::vector<uint64_t> state;
  bool absorbing;
  int index;

  inline uint64_t mulmod(uint64_t a, uint64_t b) const {
    return (uint64_t)(((u128)a * b) % q);
  }
  inline uint64_t addmod(uint64_t a, uint64_t b) const {
    uint64_t s = a + b;
    if (s < a || s >= q) s -= q;
    return s;
  }
  inline uint64_t powmod(uint64_t a, uint64_t e) const {
    uint64_t r = 1 % q, base = a;
    while (e) {
      if (e & 1) r = mulmod(r, base);
      base = mulmod(base, base);
      e >>= 1;
    }
    return r;
  }

  void permute() {
    int half = full_rounds / 2;
    int total = full_rounds + partial_rounds;
    std::vector<uint64_t> next(t);
    for (int rnd = 0; rnd < total; ++rnd) {
      const uint64_t* ark_row = &ark[(size_t)rnd * t];
      bool full = rnd < half || rnd >= half + partial_rounds;
      for (int i = 0; i < t; ++i) state[i] = addmod(state[i], ark_row[i]);
      if (full) {
        for (int i = 0; i < t; ++i) state[i] = powmod(state[i], alpha);
      } else {
        state[0] = powmod(state[0], alpha);
      }
      for (int i = 0; i < t; ++i) {
        const uint64_t* mrow = &mds[(size_t)i * t];
        u128 acc = 0;
        for (int j = 0; j < t; ++j) {
          // acc < q (< 2^64) and product < 2^128 - 2^65, so the sum fits u128
          acc = ((u128)mrow[j] * state[j] + acc) % q;
        }
        next[i] = (uint64_t)acc;
      }
      state.swap(next);
    }
  }

  void absorb(const uint64_t* elems, int n) {
    if (n == 0) return;
    if (!absorbing) {
      permute();
      absorbing = true;
      index = 0;
    }
    int pos = 0;
    int idx = index;
    while (true) {
      if (idx + (n - pos) <= rate) {
        for (int i = pos; i < n; ++i)
          state[capacity + idx + (i - pos)] =
              addmod(state[capacity + idx + (i - pos)], elems[i] % q);
        index = idx + (n - pos);
        return;
      }
      int num = rate - idx;
      for (int i = 0; i < num; ++i)
        state[capacity + idx + i] = addmod(state[capacity + idx + i], elems[pos + i] % q);
      permute();
      pos += num;
      idx = 0;
    }
  }

  void squeeze(uint64_t* out, int n) {
    if (n == 0) return;
    if (absorbing) {
      permute();
      absorbing = false;
      index = 0;
    }
    int pos = 0;
    int idx = index;
    while (true) {
      if (idx + (n - pos) <= rate) {
        for (int i = pos; i < n; ++i) out[i] = state[capacity + idx + (i - pos)];
        index = idx + (n - pos);
        return;
      }
      int num = rate - idx;
      for (int i = 0; i < num; ++i) out[pos + i] = state[capacity + idx + i];
      permute();
      pos += num;
      idx = 0;
    }
  }
};

}  // namespace

extern "C" {

void* lf_sponge_new(uint64_t q, int rate, int capacity, int full_rounds,
                    int partial_rounds, uint64_t alpha, const uint64_t* ark,
                    const uint64_t* mds) {
  Sponge* s = new Sponge();
  s->q = q;
  s->rate = rate;
  s->capacity = capacity;
  s->t = rate + capacity;
  s->full_rounds = full_rounds;
  s->partial_rounds = partial_rounds;
  s->alpha = alpha;
  int t = s->t;
  s->ark.assign(ark, ark + (size_t)(full_rounds + partial_rounds) * t);
  s->mds.assign(mds, mds + (size_t)t * t);
  s->state.assign(t, 0);
  s->absorbing = true;
  s->index = 0;
  return s;
}

void lf_sponge_free(void* h) { delete (Sponge*)h; }

void lf_sponge_absorb(void* h, const uint64_t* elems, int n) {
  ((Sponge*)h)->absorb(elems, n);
}

void lf_sponge_squeeze(void* h, uint64_t* out, int n) {
  ((Sponge*)h)->squeeze(out, n);
}

void* lf_sponge_clone(void* h) { return new Sponge(*(Sponge*)h); }

void lf_sponge_get_state(void* h, uint64_t* out_state, int* out_index,
                         int* out_absorbing) {
  Sponge* s = (Sponge*)h;
  std::memcpy(out_state, s->state.data(), sizeof(uint64_t) * s->t);
  *out_index = s->index;
  *out_absorbing = s->absorbing ? 1 : 0;
}

void lf_sponge_set_state(void* h, const uint64_t* state, int index,
                         int absorbing) {
  Sponge* s = (Sponge*)h;
  std::memcpy(s->state.data(), state, sizeof(uint64_t) * s->t);
  s->index = index;
  s->absorbing = absorbing != 0;
}
}
