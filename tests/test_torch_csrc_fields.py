"""The CUDA kernels' field arithmetic (latticefold_torch/csrc/field32.cuh,
field64.cuh, field256.cuh) against Python integers, on the CPU.

The headers compile as plain C++ too (field_common.cuh), so a small harness
built with g++ drives each field type with the constants that
``cuda.field_constants`` gives: load / store of the port's limb
lanes, the Montgomery product, the modular add, and a lazy sum of products
reduced once -- including long sums of the largest values, which hold the
accumulators' widths. The kernels themselves run only on the card, where
chip_smoke.py holds them against their plain versions.

Tolerance: exact equality -- every result is an integer mod q."""

import random
import shutil
import subprocess

import pytest

from latticefold_torch import cuda
from latticefold_torch.rings.construct import get_ring

HARNESS = r"""
#include <cstdio>
#include "field32.cuh"
#include "field64.cuh"
#include "field256.cuh"

template <class F>
typename F::Elem read_elem() {
  long long lanes[F::NL];
  for (int i = 0; i < F::NL; ++i) scanf("%lld", &lanes[i]);
  return F::load(lanes);
}

template <class F>
void print_elem(const typename F::Elem& v) {
  long long lanes[F::NL];
  F::store(lanes, v);
  for (int i = 0; i < F::NL; ++i) printf("%lld ", lanes[i]);
}

// per case: m pairs (x, y) -> mul(x0, y0), add(x0, y0), reduce(sum x y)
template <class F>
int run() {
  int nc, cases;
  unsigned long long c[16];
  scanf("%d", &nc);
  for (int i = 0; i < nc; ++i) scanf("%llu", &c[i]);
  const F f = F::from(c);
  scanf("%d", &cases);
  for (int k = 0; k < cases; ++k) {
    int m;
    scanf("%d", &m);
    typename F::Acc acc;
    F::zero(acc);
    typename F::Elem x0 = {}, y0 = {};
    for (int j = 0; j < m; ++j) {
      const typename F::Elem x = read_elem<F>();
      const typename F::Elem y = read_elem<F>();
      F::mac(acc, x, y);
      if (j == 0) {
        x0 = x;
        y0 = y;
      }
    }
    print_elem<F>(f.mul(x0, y0));
    print_elem<F>(f.add(x0, y0));
    print_elem<F>(f.reduce(acc));
    printf("\n");
  }
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
        pytest.skip("g++ is not on PATH: the field headers cannot be compiled on the host")
    d = tmp_path_factory.mktemp("fields")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
        check=True, capture_output=True, text=True,
    )
    return str(exe)


def limbs(v, nl):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nl)]


def from_limbs(vals):
    return sum(int(v) << (32 * i) for i, v in enumerate(vals))


@pytest.mark.parametrize("name", ["babybear", "goldilocks", "frog", "stark"])
def test_field_header_matches_python_ints(harness, name):
    ring = get_ring(name)
    q, nl = ring.q, ring.nl
    R = 1 << (32 * nl)
    rinv = pow(R, -1, q)
    rng = random.Random(nl * 1000 + ring.d)
    cases = []
    for m in (1, 2, 3, 72, 257):
        cases.append([(rng.randrange(q), rng.randrange(q)) for _ in range(m)])
    # edge values, and the longest sums of the largest values the kernels
    # reduce at once (a commit chunk is at most n = 2^15 terms)
    cases.append([(q - 1, q - 1)])
    cases.append([(0, q - 1), (q - 1, 1)])
    cases.append([(q - 1, q - 1)] * (1 << 15))
    words = list(cuda.field_constants(q, nl))
    lines = [str(nl), f"{len(words)} " + " ".join(map(str, words)), str(len(cases))]
    for case in cases:
        flat = [str(len(case))]
        for x, y in case:
            flat += [str(v) for v in limbs(x, nl) + limbs(y, nl)]
        lines.append(" ".join(flat))
    out = subprocess.run(
        [harness], input="\n".join(lines) + "\n", capture_output=True, text=True, check=True
    ).stdout.split("\n")
    for case, line in zip(cases, out):
        vals = [int(v) for v in line.split()]
        assert len(vals) == 3 * nl
        got = [from_limbs(vals[i * nl : (i + 1) * nl]) for i in range(3)]
        x0, y0 = case[0]
        want = [
            x0 * y0 * rinv % q,
            (x0 + y0) % q,
            sum(x * y for x, y in case) * rinv % q,
        ]
        assert got == want, (len(case), got, want)


def test_field_constants_per_width():
    """The words each field type reads: Montgomery constants of R = 2^(32 nl)
    (field32: -q^-1 mod 2^32 and 2^-32 mod q; field64 and field256:
    -q^-1 mod 2^64 and powers of the radix mod q)."""
    for name in ("babybear", "goldilocks", "stark"):
        ring = get_ring(name)
        q, nl = ring.q, ring.nl
        w = list(cuda.field_constants(q, nl))
        if nl == 1:
            assert (q * w[1]) % (1 << 32) == (1 << 32) - 1 and (w[3] << 32) % q == 1
            assert w[2] == (1 << 64) % q
        elif nl == 2:
            assert (q * w[1]) % (1 << 64) == (1 << 64) - 1 and w[3] == (1 << 128) % q
        else:
            assert from_limbs([v for x in w[:4] for v in limbs(x, 2)]) == q
            assert (q * w[4]) % (1 << 64) == (1 << 64) - 1
            r1 = sum(x << (64 * i) for i, x in enumerate(w[5:9]))
            r2 = sum(x << (64 * i) for i, x in enumerate(w[9:13]))
            assert (r1, r2) == ((1 << 256) % q, (1 << 512) % q)
    with pytest.raises(NotImplementedError):
        cuda.field_constants(get_ring("goldilocks").q, 4)

