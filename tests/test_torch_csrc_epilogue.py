"""The byte-plane commit epilogue's per-output arithmetic
(latticefold_torch/csrc/plane_epilogue.cuh: the base-256 carry of
byte-position sums, byte at a time (``carry_pack``) and limb at a time
(``carry_limbs64``), and the wide Montgomery reduction by
R2 = 2^(32 (nl + 1))) against Python integers, on the CPU.

The header compiles as plain C++ too (field_common.cuh), so a small harness
built with g++ takes position sums, with the constants it reads from
``cuda.field_constants``, and prints the reduced limbs. Position sums come
from real operands: n products of two values below q, split into bytes,
including the largest values and the longest contractions the commit
reduces at once (four 2^15-term slices), where each position sum is at its
worst. Kernel B itself runs only on the card, where chip_smoke.py holds it
against its plain version.

Tolerance: exact equality -- every result is an integer mod q."""

import random
import shutil
import subprocess

import pytest

from latticefold_torch import cuda
from latticefold_torch.rings.construct import get_ring

HARNESS = r"""
#include <cstdio>
#include "plane_epilogue.cuh"

// per case: the number of position sums, then the sums -> the NL limbs
template <int NL>
int run() {
  int nc, cases;
  unsigned long long c[16];
  scanf("%d", &nc);
  for (int i = 0; i < nc; ++i) scanf("%llu", &c[i]);
  const WideRedc<NL> wr = WideRedc<NL>::from(c);
  scanf("%d", &cases);
  for (int k = 0; k < cases; ++k) {
    int nu;
    unsigned long long u[64];
    scanf("%d", &nu);
    for (int s = 0; s < nu; ++s) scanf("%llu", &u[s]);
    u32 t[2 * NL + 2], out[NL];
    carry_pack<NL>(u, nu, t);
    wr.reduce(t, out);
    for (int i = 0; i < NL; ++i) printf("%u ", out[i]);
    printf("\n");
  }
  return 0;
}

int main() {
  int nl;
  scanf("%d", &nl);
  if (nl == 1) return run<1>();
  if (nl == 2) return run<2>();
  if (nl == 8) return run<8>();
  return 1;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the epilogue header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("epilogue")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
        check=True, capture_output=True, text=True,
    )
    return str(exe)


def byte_list(v, nl):
    return [(v >> (8 * i)) & 0xFF for i in range(4 * nl)]


def position_sums(pairs, nl):
    """sum over (x, y, count) of count * x * y, as byte-position sums u[s]
    (s < 8 nl - 1), the way the plane products group."""
    u = [0] * (8 * nl - 1)
    for x, y, count in pairs:
        bx, by = byte_list(x, nl), byte_list(y, nl)
        for i, a in enumerate(bx):
            for j, b in enumerate(by):
                u[i + j] += count * a * b
    return u


@pytest.mark.parametrize("name", ["babybear", "goldilocks", "stark"])
def test_carry_and_wide_reduction_match_python_ints(harness, name):
    ring = get_ring(name)
    q, nl = ring.q, ring.nl
    r2inv = pow(1 << (32 * (nl + 1)), -1, q)
    rng = random.Random(nl * 7919 + 3)
    top = (1 << (q.bit_length() - 1)) - 1  # every bit below q's top bit: the most 0xFF bytes
    cases = [
        [(0, 0, 1)],
        [(1, 1, 1)],
        [(q - 1, q - 1, 1)],
        [(q - 1, q - 1, 4 << 15)],  # every term the largest value: the worst position sums
        [(top, top, 4 << 15)],
        [(top, q - 1, 3 << 15), (q - 1, top, 1 << 15)],
    ]
    for _ in range(8):
        cases.append([(rng.randrange(q), rng.randrange(q), rng.randrange(1, 1 << 17)) for _ in range(3)])
    words = list(cuda.field_constants(q, nl))
    lines = [str(nl), f"{len(words)} " + " ".join(map(str, words)), str(len(cases))]
    sums = [position_sums(case, nl) for case in cases]
    for u in sums:
        assert max(u) < 1 << 64
        lines.append(f"{len(u)} " + " ".join(map(str, u)))
    out = subprocess.run(
        [harness], input="\n".join(lines) + "\n", capture_output=True, text=True, check=True
    ).stdout.split("\n")
    for case, u, line in zip(cases, sums, out):
        vals = [int(v) for v in line.split()]
        got = sum(v << (32 * i) for i, v in enumerate(vals))
        T = sum(v << (8 * s) for s, v in enumerate(u))
        assert T == sum(x * y * count for x, y, count in case)
        assert T < q << (32 * (nl + 1))  # the reduction's precondition
        assert len(vals) == nl and got == T * r2inv % q, (case, got)


LIMB_HARNESS = r"""
#include <cstdio>
#include "plane_epilogue.cuh"

// per case: the number of position sums, then the sums -> the 2NL+2 limbs
// of carry_limbs64, then those of carry_pack
template <int NL>
int run() {
  int cases;
  scanf("%d", &cases);
  for (int k = 0; k < cases; ++k) {
    int nu;
    unsigned long long u[64];
    scanf("%d", &nu);
    for (int s = 0; s < nu; ++s) scanf("%llu", &u[s]);
    u32 t[2 * NL + 2], b[2 * NL + 2];
    carry_limbs64<NL>(u, nu, t);
    carry_pack<NL>(u, nu, b);
    for (int i = 0; i < 2 * NL + 2; ++i) printf("%u ", t[i]);
    for (int i = 0; i < 2 * NL + 2; ++i) printf("%u ", b[i]);
    printf("\n");
  }
  return 0;
}

int main() {
  int nl;
  scanf("%d", &nl);
  if (nl == 1) return run<1>();
  if (nl == 2) return run<2>();
  if (nl == 8) return run<8>();
  return 1;
}
"""


@pytest.mark.parametrize("nl", [1, 2, 8])
def test_limb_carry_matches_byte_carry_and_python_ints(tmp_path, nl):
    """``carry_limbs64`` (the diagonal kernel's carry) gives the limbs of T
    for position sums up to 2^63, the same as ``carry_pack``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the epilogue header cannot be compiled on the host")
    src = tmp_path / "limbs.cpp"
    src.write_text(LIMB_HARNESS)
    exe = tmp_path / "limbs"
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    rng = random.Random(nl * 31 + 5)
    nu = 8 * nl - 1
    limit = 32 * (2 * nl + 1)  # T below 2^limit: carry_pack's precondition
    cases = [[0] * nu, [(1 << 63) - 1] + [0] * (nu - 1), [255] * nu]
    for bits in (31, 36, 48, 63):
        for _ in range(4):
            # u[s] below 2^(limit - 8 s - 4): T below 2^limit
            cases.append([rng.randrange(1 << max(1, min(bits, limit - 8 * s - 4))) for s in range(nu)])
    lines = [str(nl), str(len(cases))] + [f"{nu} " + " ".join(map(str, u)) for u in cases]
    out = subprocess.run([str(exe)], input="\n".join(lines) + "\n", capture_output=True, text=True,
                         check=True).stdout.split("\n")
    for u, line in zip(cases, out):
        vals = [int(v) for v in line.split()]
        limbs, bytewise = vals[: 2 * nl + 2], vals[2 * nl + 2 :]
        T = sum(v << (8 * s) for s, v in enumerate(u))
        assert limbs == bytewise, u
        assert sum(v << (32 * i) for i, v in enumerate(limbs)) == T and limbs[-1] == 0, u
