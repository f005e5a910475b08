"""The tensor-core CRT's index maps (latticefold_torch/csrc/crt_tc.cuh: the
conv matrix's order and chunk layout, which limb each wgmma A-operand
register holds, which element, output and byte position each accumulator
register holds, where it is staged, and the per-output finish) against
numpy and Python integers, on the CPU.

The header compiles as plain C++ too (field_common.cuh), so a small harness
built with g++ emulates one consumer warpgroup of the kernel
(csrc/crt_tc_kernel.cu) on a seeded tile of 64 elements: it loads every
A-operand register as the kernel does (``a_row``, ``a_limb``; rows past N
zero), reads each chunk of ``ops.conv_tiles`` (the bytes the kernel copies
into shared memory) as the wgmma descriptor does (the 128-byte swizzle on
the address, modelled here, not taken from the header), multiplies in the
8-bit wgmma register layouts (modelled here too), stages the accumulator
registers where the kernel does (``acc_row``, ``acc_col``,
``stage_index``) and finishes each output as the kernel's threads do
(``pair_row``, ``pair_out``, ``finish_output``). The gathered position sums
must equal numpy's dot of the elements' bytes with ``ops.conv_matrix``, and
the limbs sum_i M[o, i] x[i] R^-1 mod q in Python integers; every byte of
``ops.conv_matrix`` must sit in the layout where the header's maps
(``conv_k``, ``col_chunk``, ``col_in_chunk``, ``conv_offset``) say, and
every other byte must be zero. The bulk copies, mbarriers
and the wgmmas themselves are the card's work: chip_smoke.py holds the
kernel against ``mat_apply`` and ``crt_conv_plain`` there.

Tolerance: exact equality -- every value is an integer."""

import random
import shutil
import subprocess

import numpy as np
import pytest

from latticefold_torch import cuda
from latticefold_torch.rings import ops
from latticefold_torch.rings.construct import get_ring

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "crt_tc.cuh"

using namespace crt_tc;

// the hardware's side, modelled independently of the header: the 128-byte
// swizzle of a 1024-byte-aligned tile, and the 8-bit wgmma register layouts
static int hw_swizzle(int off) { return off ^ (((off >> 7) & 7) << 4); }
static int hw_a_row(int w, int lane, int r) { return 16 * w + lane / 4 + 8 * (r % 2); }
static int hw_a_k(int lane, int ks, int r, int i) { return 32 * ks + 4 * (lane % 4) + 16 * (r / 2) + i; }
static int hw_acc_row(int w, int lane, int j) { return 16 * w + lane / 4 + 8 * ((j / 2) % 2); }
static int hw_acc_col(int lane, int j) { return 8 * (j / 4) + 2 * (lane % 4) + j % 2; }

template <int NL, int D>
int run() {
  using S = Shape<NL, D>;
  int nrows, nc;
  unsigned long long c[16];
  if (scanf("%d %d", &nrows, &nc) != 2) return 1;
  for (int i = 0; i < nc; ++i) scanf("%llu", &c[i]);
  const WideRedc<NL> wr = WideRedc<NL>::from(c);
  std::vector<u32> x(ROWS * S::DNL);
  for (auto& v : x) scanf("%u", &v);
  std::vector<unsigned char> tiles(S::NCH * S::CHUNK_BYTES);
  for (auto& v : tiles) {
    int b;
    scanf("%d", &b);
    v = (unsigned char)b;
  }
  std::vector<int> C(S::K * D * S::SP);  // ops.conv_matrix: [i, limb l, byte b][o][s]
  for (auto& v : C) scanf("%d", &v);

  // the layout: C's byte (i, l, b; o, s) where conv_k, col_chunk,
  // col_in_chunk and conv_offset say, and every byte of the padding zero
  int misplaced = 0, nonzero = 0;
  std::vector<char> seen(tiles.size(), 0);
  for (int i = 0; i < D; ++i)
    for (int l = 0; l < NL; ++l)
      for (int b = 0; b < 4; ++b)
        for (int o = 0; o < D; ++o)
          for (int s = 0; s < S::SP; ++s) {
            const int k = conv_k(NL, i, l, b);
            const int at = conv_offset(S::CHUNK_BYTES, col_chunk(S::SP, o), col_in_chunk(S::SP, o, s), k);
            seen[at] = 1;
            if (tiles[at] != C[(k * D + o) * S::SP + s]) ++misplaced;
          }
  for (size_t at = 0; at < tiles.size(); ++at)
    if (!seen[at] && tiles[at] != 0) ++nonzero;
  misplaced += nonzero;

  // A-operand registers as the kernel loads them, read back in the hardware layout
  static int A[ROWS][S::K];
  for (int w = 0; w < 4; ++w)
    for (int lane = 0; lane < 32; ++lane)
      for (int ks = 0; ks < S::KS; ++ks)
        for (int r = 0; r < 4; ++r) {
          const int row = a_row(w, lane, r);
          const u32 reg = row < nrows ? x[row * S::DNL + a_limb(lane, ks, r)] : 0u;
          for (int i = 0; i < 4; ++i) A[hw_a_row(w, lane, r)][hw_a_k(lane, ks, r, i)] = (reg >> (8 * i)) & 0xFF;
        }

  std::vector<long long> pos((size_t)ROWS * D * S::SP, -1);
  std::vector<long long> out((size_t)ROWS * D * NL, -1);
  std::vector<int> st(ROWS * PITCH);
  for (int ch = 0; ch < S::NCH; ++ch) {
    const unsigned char* stage = tiles.data() + ch * S::CHUNK_BYTES;
    // every wgmma step: B (n, k) read through the descriptor at b_step(ks)
    static long long Dacc[ROWS][COLS];
    for (int m = 0; m < ROWS; ++m)
      for (int n = 0; n < COLS; ++n) {
        long long sum = 0;
        for (int ks = 0; ks < S::KS; ++ks)
          for (int kk = 0; kk < 32; ++kk)
            sum += (long long)A[m][32 * ks + kk] * stage[hw_swizzle(b_step(ks) + n * KB + kk)];
        Dacc[m][n] = sum;
      }
    // the accumulator registers, staged where the kernel stages them
    for (int w = 0; w < 4; ++w)
      for (int lane = 0; lane < 32; ++lane)
        for (int j = 0; j < 64; ++j)
          st[stage_index(acc_row(w, lane, j), acc_col(lane, j))] = (int)Dacc[hw_acc_row(w, lane, j)][hw_acc_col(lane, j)];
    // the finish, thread by thread
    for (int tid = 0; tid < 128; ++tid)
      for (int it = 0; it < S::PAIRS; ++it) {
        const int p = tid + 128 * it;
        const int row = pair_row(S::CPC, p), oc = pair_out(S::CPC, p);
        const int o = ch * S::CPC + oc;
        if (row >= nrows || o >= D) continue;
        const int* u = st.data() + stage_index(row, oc * S::SP);
        const int4* u4 = reinterpret_cast<const int4*>(u);
        for (int s = 0; s < S::SP; ++s) pos[((size_t)row * D + o) * S::SP + s] = u[s];
        u32 limbs[NL];
        finish_output<NL>(u4, wr, limbs);
        for (int l = 0; l < NL; ++l) out[((size_t)row * D + o) * NL + l] = limbs[l];
      }
  }
  printf("%d\n", misplaced);
  for (long long v : pos) printf("%lld ", v);
  printf("\n");
  for (long long v : out) printf("%lld ", v);
  printf("\n");
  return 0;
}

int main() {
  int nl, d;
  if (scanf("%d %d", &nl, &d) != 2) return 1;
  if (nl == 1 && d == 72) return run<1, 72>();
  if (nl == 2 && d == 24) return run<2, 24>();
  if (nl == 2 && d == 16) return run<2, 16>();
  if (nl == 8 && d == 16) return run<8, 16>();
  return 1;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the CRT header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("crt_tc")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
        check=True, capture_output=True, text=True,
    )
    return str(exe)


@pytest.mark.parametrize("name,which,nrows", [
    ("babybear", "crt", 64),  # nl 1: 16 outputs a chunk, the last chunk half past d
    ("goldilocks", "icrt", 50),  # nl 2: rows past N read as zero and are not written
    ("stark", "crt", 37),  # nl 8: 2 outputs a chunk, four k blocks
])
def test_registers_and_finish_match_numpy_and_python_ints(harness, name, which, nrows):
    ring = get_ring(name)
    d, nl, q = ring.d, ring.nl, ring.q
    rnd = random.Random(d * 31 + nl)
    vals = [rnd.randrange(q) for _ in range(64 * d)]
    vals[0], vals[1] = q - 1, 0  # the largest value and zero
    x = ring.fq.encode(np.array(vals, dtype=object)).reshape(64, d * nl)  # values as Montgomery limbs
    C = ops.conv_matrix(ring, which)  # [K, d, 8 nl]
    tiles = ops.conv_tiles(ring, which)  # [chunks, k blocks, 128, 128]
    consts = list(cuda.field_constants(q, nl))
    text = "\n".join([
        f"{nl} {d}", f"{nrows} {len(consts)}", " ".join(map(str, consts)),
        " ".join(map(str, x.ravel())), " ".join(map(str, tiles.ravel())), " ".join(map(str, C.ravel())),
    ]) + "\n"
    out = subprocess.run([harness], input=text, capture_output=True, text=True, check=True).stdout.split("\n")
    assert int(out[0]) == 0  # every byte of C where the header's maps say, the padding zero
    pos = np.array(out[1].split(), dtype=np.int64).reshape(64, d, 8 * nl)
    got = np.array(out[2].split(), dtype=np.int64).reshape(64, d, nl)
    assert (pos[nrows:] == -1).all() and (got[nrows:] == -1).all()  # rows past N never written
    xbytes = x[:nrows].astype("<u4").view(np.uint8).reshape(nrows, -1).astype(np.int64)
    assert np.array_equal(pos[:nrows], (xbytes @ C.reshape(C.shape[0], -1).astype(np.int64)).reshape(nrows, d, -1))
    rows = {"crt": ring.crt_rows, "icrt": ring.icrt_rows}[which]
    R = 1 << (32 * nl)
    rinv = pow(R, -1, q)
    M = [[v * R % q for v in row] for row in rows]  # the Montgomery matrix
    xs = np.array(vals, dtype=object).reshape(64, d)
    want = [[sum(M[o][i] * int(xs[n, i]) for i in range(d)) * rinv % q for o in range(d)] for n in range(nrows)]
    assert np.array_equal(ring.fq.decode(got[:nrows].astype(np.uint32)), np.array(want, dtype=object))
