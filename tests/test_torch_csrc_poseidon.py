"""The Poseidon kernel's arithmetic (latticefold_torch/csrc/poseidon.cuh, on
field32/64/256.cuh) against the port's host sponge, on the CPU.

The header compiles as plain C++ (field_common.cuh), so a small harness
built with g++ runs ``lf_poseidon_serial`` -- the s-box and MDS row of the
kernel's lanes, one word after the other -- on the Montgomery constants of
``transcript.device._perm_consts`` and a seeded state, for each ring, and
the result must be ``PoseidonSponge._permute`` of the same state. The
kernel itself runs only on the card, where chip_smoke.py holds it against
its plain version (``transcript.device.permute_plain``).

Tolerance: exact equality -- every value is an integer mod q."""

import shutil
import subprocess

import numpy as np
import pytest

from latticefold_torch import cuda
from latticefold_torch.rings.construct import get_ring
from latticefold_torch.transcript import device as dtr
from latticefold_torch.transcript.poseidon import PoseidonSponge, get_config

HARNESS = r"""
#include <cstdio>
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

// input: consts, t, rf, rp, ark, mds, state; output: the permuted state
template <class F>
int run() {
  int nc, t, rf, rp;
  unsigned long long c[16];
  scanf("%d", &nc);
  for (int i = 0; i < nc; ++i) scanf("%llu", &c[i]);
  const F f = F::from(c);
  scanf("%d %d %d", &t, &rf, &rp);
  std::vector<typename F::Elem> ark = read_elems<F>((rf + rp) * t);
  std::vector<typename F::Elem> mds = read_elems<F>(t * t);
  std::vector<typename F::Elem> state = read_elems<F>(t);
  std::vector<typename F::Elem> scratch(t);
  lf_poseidon_serial(f, state.data(), ark.data(), mds.data(), t, rf, rp, scratch.data());
  for (int k = 0; k < t; ++k) {
    long long lanes[F::NL];
    F::store(lanes, state[k]);
    for (int i = 0; i < F::NL; ++i) printf("%lld ", lanes[i]);
  }
  printf("\n");
  return 0;
}

int main() {
  int nl;
  scanf("%d", &nl);
  if (nl == 1) return run<F32>();
  if (nl == 2) return run<F64>();
  if (nl == 8) return run<F256>();
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


@pytest.mark.parametrize("name", ["babybear", "goldilocks", "frog", "stark"])
def test_poseidon_header_matches_host_sponge(harness, name):
    ring = get_ring(name)
    q, nl = ring.q, ring.nl
    R = 1 << (32 * nl)
    cfg = get_config(q)
    t = cfg.rate + cfg.capacity
    ark, mds, _ = dtr._perm_consts(ring)
    rng = np.random.default_rng(ring.d)
    vals = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(t)]
    state = ring.fq.encode(np.array([v * R % q for v in vals], dtype=object))

    def lanes(a):
        return " ".join(str(int(v)) for v in np.asarray(a, dtype=np.int64).reshape(-1))

    consts = list(cuda.field_constants(q, nl))
    text = (f"{nl}\n{len(consts)} {' '.join(map(str, consts))}\n{t} {cfg.full_rounds} {cfg.partial_rounds}\n"
            f"{lanes(ark)}\n{lanes(mds)}\n{lanes(state)}\n")
    out = subprocess.run([harness], input=text, capture_output=True, text=True, check=True).stdout.split()
    got = ring.fq.decode(np.array([int(v) for v in out], dtype=np.uint32).reshape(t, nl))
    host = PoseidonSponge(cfg)
    host.state = list(vals)
    host._permute()
    assert [int(v) * pow(R, -1, q) % q for v in got] == host.state
