"""The Poseidon kernels' arithmetic (latticefold_torch/csrc/poseidon.cuh, on
field32/64/256.cuh) against the port's host sponge, on the CPU.

The header compiles as plain C++ (field_common.cuh), so a small harness
built with g++ runs, for each ring, on a seeded state:

- ``lf_poseidon_serial`` (the first kernel's rounds: the s-box and MDS row
  of its lanes, one word after the other) on the Montgomery constants of
  ``transcript.device._perm_consts``;
- ``lf_poseidon_fast_serial`` (the sponge kernel's factored rounds: the
  partial rounds' constants moved forward, their sparse matrices, their
  dots unrolled) on the
  very bytes the sponge kernel copies into shared memory
  (``transcript.device.sponge_consts``);
- ``lf_sponge_call_serial`` (the sponge kernel's schedule of one absorb or
  squeeze call) on multi-permutation absorbs and squeezes, at a mode switch,
  with a trailing chunk, from a rate resting full, and with 0 permutations;

and the result must be ``PoseidonSponge._permute`` of the same state, or
the host sponge's ``absorb`` / ``squeeze_native`` from the same state,
index and mode (state, index and squeezed values). The host-side factored
constants (``transcript.device.fast_consts``) are also run as Python ints
against the plain rounds. The kernels themselves run only on the card, where
chip_smoke.py holds them against their plain versions
(``transcript.device.permute_plain``, ``sponge_call_plain``).

Tolerance: exact equality -- every value is an integer mod q."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from latticefold_torch import cuda
from latticefold_torch.rings.construct import get_ring
from latticefold_torch.transcript import device as dtr
from latticefold_torch.transcript.poseidon import PoseidonSponge, get_config

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "field32.cuh"
#include "field64.cuh"
#include "field256.cuh"
#include "poseidon.cuh"

template <class F>
std::vector<typename F::Elem> read_elems(int n) {
  std::vector<typename F::Elem> out(n);
  for (int k = 0; k < n; ++k) {
    long long lanes[F::NL];
    for (int i = 0; i < F::NL; ++i) scanf("%lld", &lanes[i]);
    out[k] = F::load(lanes);
  }
  return out;
}

template <class F>
void write_elems(const typename F::Elem* v, int n) {
  for (int k = 0; k < n; ++k) {
    long long lanes[F::NL];
    F::store(lanes, v[k]);
    for (int i = 0; i < F::NL; ++i) printf("%lld ", lanes[i]);
  }
  printf("\n");
}

// the sponge kernel's constant buffer: nbytes / 8 int64 words, as Elems
template <class F>
std::vector<typename F::Elem> read_packed() {
  int nbytes;
  scanf("%d", &nbytes);
  std::vector<long long> words(nbytes / 8);
  for (auto& w : words) scanf("%lld", &w);
  std::vector<typename F::Elem> out(nbytes / sizeof(typename F::Elem));
  memcpy(out.data(), words.data(), nbytes);
  return out;
}

// input: mode, consts, t, rf, rp, then
//   mode 0: ark, mds, state          -> the permuted state (round by round)
//   mode 1: packed, state            -> the permuted state (factored)
//   mode 2: packed, rate, calls, state, then per call: n idx sw absorb
//           [vals]                   -> per call: the state, the index and
//                                       the squeezed values
//   mode 3: count, lazy sums (u64 words) -> lf_reduce_fast of each
template <class F>
int run(int mode) {
  int nc, t, rf, rp;
  unsigned long long c[16];
  scanf("%d", &nc);
  for (int i = 0; i < nc; ++i) scanf("%llu", &c[i]);
  const F f = F::from(c);
  scanf("%d %d %d", &t, &rf, &rp);
  std::vector<typename F::Elem> scratch(t);
  if (mode == 0) {
    std::vector<typename F::Elem> ark = read_elems<F>((rf + rp) * t);
    std::vector<typename F::Elem> mds = read_elems<F>(t * t);
    std::vector<typename F::Elem> state = read_elems<F>(t);
    lf_poseidon_serial(f, state.data(), ark.data(), mds.data(), t, rf, rp, scratch.data());
    write_elems<F>(state.data(), t);
    return 0;
  }
  if (mode == 3) {  // lf_reduce_fast on lazy sums given as u64 words
    int cnt;
    scanf("%d", &cnt);
    for (int k = 0; k < cnt; ++k) {
      typename F::Acc a;
      unsigned long long* w = reinterpret_cast<unsigned long long*>(&a);
      for (size_t i = 0; i < sizeof(a) / 8; ++i) scanf("%llu", &w[i]);
      const typename F::Elem r = lf_reduce_fast(f, a);
      write_elems<F>(&r, 1);
    }
    return 0;
  }
  std::vector<typename F::Elem> cs = read_packed<F>();
  if ((int)cs.size() < lf_fast_elems(t, rf, rp)) return 2;
  if (mode == 1) {
    std::vector<typename F::Elem> state = read_elems<F>(t);
    lf_poseidon_fast_serial(f, state.data(), cs.data(), t, rf, rp, scratch.data());
    write_elems<F>(state.data(), t);
    return 0;
  }
  int rate, calls;
  scanf("%d %d", &rate, &calls);
  std::vector<typename F::Elem> state = read_elems<F>(t);
  for (int k = 0; k < calls; ++k) {
    int n, idx, sw, absorb;
    scanf("%d %d %d %d", &n, &idx, &sw, &absorb);
    std::vector<typename F::Elem> vals = absorb ? read_elems<F>(n) : std::vector<typename F::Elem>();
    std::vector<typename F::Elem> out(absorb ? 0 : n);
    const int end = lf_sponge_call_serial(f, state.data(), absorb ? vals.data() : nullptr, out.data(), n, idx,
                                          sw != 0, t, rate, rf, rp, cs.data(), scratch.data());
    write_elems<F>(state.data(), t);
    printf("%d\n", end);
    write_elems<F>(out.data(), (int)out.size());
  }
  return 0;
}

int main() {
  int nl, mode;
  scanf("%d %d", &nl, &mode);
  if (nl == 1) return run<F32>(mode);
  if (nl == 2) return run<F64>(mode);
  if (nl == 8) return run<F256>(mode);
  return 1;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the Poseidon header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("poseidon")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
        check=True, capture_output=True, text=True,
    )
    return str(exe)


RINGS = ["babybear", "goldilocks", "frog", "stark"]


def lanes(a):
    return " ".join(str(int(v)) for v in np.asarray(a, dtype=np.int64).reshape(-1))


def mont(ring, vals):
    R = 1 << (32 * ring.nl)
    return ring.fq.encode(np.array([v * R % ring.q for v in vals], dtype=object))


def seeded(ring, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % ring.q for _ in range(n)]


def header(ring, mode):
    """The harness's first lines: nl, mode, the field's words, t, rf, rp."""
    cfg = get_config(ring.q)
    consts = list(cuda.field_constants(ring.q, ring.nl))
    return (f"{ring.nl} {mode}\n{len(consts)} {' '.join(map(str, consts))}\n"
            f"{cfg.rate + cfg.capacity} {cfg.full_rounds} {cfg.partial_rounds}\n")


def packed(ring):
    buf, nbytes = dtr.sponge_consts(ring, torch.device("cpu"))
    return f"{nbytes} {lanes(buf)}\n"


def run_harness(harness, text):
    return subprocess.run([harness], input=text, capture_output=True, text=True, check=True).stdout


def to_ints(ring, words):
    """Montgomery limbs (harness output) -> canonical ints."""
    R = 1 << (32 * ring.nl)
    got = ring.fq.decode(np.array([int(v) for v in words], dtype=np.uint32).reshape(-1, ring.nl))
    return [int(v) * pow(R, -1, ring.q) % ring.q for v in got]


@pytest.mark.parametrize("name", RINGS)
def test_poseidon_header_matches_host_sponge(harness, name):
    ring = get_ring(name)
    cfg = get_config(ring.q)
    t = cfg.rate + cfg.capacity
    ark, mds, _ = dtr._perm_consts(ring)
    vals = seeded(ring, t, ring.d)
    text = header(ring, 0) + f"{lanes(ark)}\n{lanes(mds)}\n{lanes(mont(ring, vals))}\n"
    host = PoseidonSponge(cfg)
    host.state = list(vals)
    host._permute()
    assert to_ints(ring, run_harness(harness, text).split()) == host.state


@pytest.mark.parametrize("name", RINGS)
@pytest.mark.parametrize("unrolled", [False, True], ids=["sparse", "unrolled"])
def test_fast_consts_match_plain_rounds(name, unrolled):
    """The factored form on ``fast_consts``, as Python ints, is the plain
    permutation (``PoseidonSponge._permute``): its partial rounds as sparse
    matrix products, or unrolled (the dots D_l of the entry state, the sums
    of C_lk s_k and v_k s_k: csrc/poseidon.cuh)."""
    ring = get_ring(name)
    q, cfg = ring.q, get_config(ring.q)
    t, half, rp = cfg.rate + cfg.capacity, cfg.full_rounds // 2, cfg.partial_rounds
    fc = dtr.fast_consts(ring)
    assert [len(fc[k]) for k in ("ark", "mds", "pre", "part", "cmat")] == [cfg.full_rounds, t, t, rp, rp]
    x = seeded(ring, t, 5)
    host = PoseidonSponge(cfg)
    host.state = list(x)
    host._permute()
    part = fc["part"]
    for r in range(cfg.full_rounds):
        if r == half and not unrolled:
            for p in part:
                s0 = pow((x[0] + p[0]) % q, 7, q)
                x = ([(p[1] * s0 + sum(p[1 + j] * x[j] for j in range(1, t))) % q]
                     + [(x[j] + p[t + j] * s0) % q for j in range(1, t)])
        elif r == half:
            d = [sum(part[k][1 + j] * x[j] for j in range(1, t)) for k in range(rp)]
            sk = []
            for k in range(rp):
                sk.append(pow((x[0] + part[k][0]) % q, 7, q))
                x[0] = (part[k][1] * sk[k] + d[k] + sum(fc["cmat"][k][l] * sk[l] for l in range(k))) % q
            x = [x[0]] + [(x[j] + sum(part[k][t + j] * sk[k] for k in range(rp))) % q for j in range(1, t)]
        s = [pow((x[i] + fc["ark"][r][i]) % q, 7, q) for i in range(t)]
        m = fc["pre"] if r == half - 1 else fc["mds"]
        x = [sum(m[i][j] * s[j] for j in range(t)) % q for i in range(t)]
    assert x == host.state


@pytest.mark.parametrize("name", RINGS)
def test_poseidon_fast_header_matches_host_sponge(harness, name):
    ring = get_ring(name)
    cfg = get_config(ring.q)
    vals = seeded(ring, cfg.rate + cfg.capacity, ring.d + 1)
    text = header(ring, 1) + packed(ring) + f"{lanes(mont(ring, vals))}\n"
    host = PoseidonSponge(cfg)
    host.state = list(vals)
    host._permute()
    assert to_ints(ring, run_harness(harness, text).split()) == host.state


@pytest.mark.parametrize("name", RINGS)
def test_reduce_fast_edges(harness, name):
    """``lf_reduce_fast`` (the kernels' reduction of a lazy sum: Montgomery
    products at nl 1, the field's reduce otherwise) at the edges of the sums
    the sponge kernel forms (up to 25 products of values below q): words of
    0 and all ones, the largest sum, seeded sums."""
    ring = get_ring(name)
    q, R = ring.q, 1 << (32 * ring.nl)
    words = {1: 2, 2: 3, 8: 9}[ring.nl]
    top = 25 * (q - 1) ** 2
    ones = (1 << 64) - 1
    sums = [0, 1, top, top - 1, ones, ones << 64, (ones << 64) | ones, (1 << 128) + ones, q * q]
    sums += [int(v) for v in np.random.default_rng(9).integers(0, 1 << 62, size=8)]
    sums += [v * (top >> 62) % top for v in sums[-8:]]
    sums = [v for v in sums if v <= top]
    text = header(ring, 3) + f"{len(sums)} " + " ".join(
        str((v >> (64 * i)) & ones) for v in sums for i in range(words)) + "\n"
    got = to_ints(ring, run_harness(harness, text).split())
    assert got == [v * pow(R, -1, q) % q * pow(R, -1, q) % q for v in sums]


# (n, absorb, mode switch or the rate index to continue at): a multi-permutation
# absorb at a switch with a trailing chunk, an absorb of 0 permutations, one
# that fills the rate exactly (resting at index == rate), one from that
# resting state, a squeeze at a switch across permutations, a squeeze of 0
# permutations, one that crosses the rate, and an absorb after it
CALLS = [(67, True), (5, True), (8, True), (21, True), (45, False), (3, False), (30, False), (2, True)]


@pytest.mark.parametrize("name", RINGS)
def test_sponge_call_header_matches_host_sponge(harness, name):
    ring = get_ring(name)
    cfg = get_config(ring.q)
    t = cfg.rate + cfg.capacity
    x0 = seeded(ring, t, ring.d + 2)
    host = PoseidonSponge(cfg)
    host.state, host.mode_absorbing, host.index = list(x0), False, 13
    text = [header(ring, 2), packed(ring), f"{cfg.rate} {len(CALLS)}\n{lanes(mont(ring, x0))}\n"]
    want = []
    idx, absorbing = host.index, host.mode_absorbing
    for i, (n, absorb) in enumerate(CALLS):
        text.append(f"{n} {idx} {int(absorbing != absorb)} {int(absorb)}\n")
        if absorb:
            vals = seeded(ring, n, 100 + i)
            text.append(lanes(mont(ring, vals)) + "\n")
            host.absorb(vals)
            out = []
        else:
            out = host.squeeze_native(n)
        want.append((list(host.state), host.index, out))
        if i == 2:
            assert host.index == cfg.rate
        idx, absorbing = host.index, host.mode_absorbing
    lines = run_harness(harness, "".join(text)).split("\n")
    for i, (state, index, out) in enumerate(want):
        got_state, got_idx, got_out = lines[3 * i : 3 * i + 3]
        assert to_ints(ring, got_state.split()) == state, f"call {i}: state"
        assert int(got_idx) == index, f"call {i}: index"
        assert to_ints(ring, got_out.split()) == out, f"call {i}: squeezed values"
