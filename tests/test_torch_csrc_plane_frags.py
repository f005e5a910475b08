"""The witness side of kernel A's Hopper dot
(latticefold_torch/csrc/plane_frags_sm90.cuh: where each word lies in a
stage, how a consumer builds its wgmma A-operand registers, the signed
byte planes, with prmt and the XOR, or the dot-only probe's fake planes,
which plane column and Ajtai row each accumulator register holds, and the
K-major lhs's stage transpose) against the plain planes, on the CPU.

The header compiles as plain C++ too (``__byte_perm`` has a host
definition), so a small harness built with g++ stages seeded random words
one 128-deep stage at a time, laid out as the stage's TMA box writes them
(u32 words, their rows swizzled as TMA's 128-byte swizzle writes them, or
int64 lanes; zero words past L and past the slice's end),
builds every register of every consumer warpgroup, multiplies the registers
by an Ajtai tile in the wgmma's 8-bit register layout and scatters the
accumulators as the kernel stores them. The result must equal ``plane_dot_plain``, and
every plane of a word past L must read -128 (0 XOR 0x80; 0 for the fake
planes). With a K-major lhs the harness lays each stage's Ajtai tile out as
TMA writes it MN-major (k-rows of N bytes), runs every consumer warp's
part of ``transpose_stage`` and reads the Ajtai rows back from the copy
through the 128-byte swizzle that the wgmma descriptor reads. The TMA
copies themselves are the card's work: chip_smoke.py holds the kernel
itself against ``plane_dot_plain``.

Tolerance: exact equality -- every value is an integer."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from latticefold_torch import cuda
from latticefold_torch.rings import plane_commit as tpc

KB = 128

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "plane_frags_sm90.cuh"

using namespace sm90;

int main() {
  int wt, wstride, L, kvalid, N, fake, kmajor, swz;
  if (scanf("%d %d %d %d %d %d %d %d", &wt, &wstride, &L, &kvalid, &N, &fake, &kmajor, &swz) != 8) return 1;
  std::vector<int> lhs(N * KB);
  for (auto& v : lhs) scanf("%d", &v);
  if (kmajor) {
    // the stage's Ajtai tile as TMA writes a K-major lhs's box: KB k-rows of
    // N bytes; the consumers' transpose into the swizzled K-major copy, which
    // starts as garbage; the rows read back through the swizzle
    std::vector<unsigned char> raw(KB * N), copy(N * KB, 0xA5);
    for (int n = 0; n < N; ++n)
      for (int k = 0; k < KB; ++k) raw[k * N + n] = (unsigned char)lhs[n * KB + k];
    for (int warp = 0; warp < 8; ++warp)
      for (int lane = 0; lane < 32; ++lane) {
        if (N == 224) transpose_stage<224>((const u32*)raw.data(), (u32*)copy.data(), warp, lane);
        if (N == 192) transpose_stage<192>((const u32*)raw.data(), (u32*)copy.data(), warp, lane);
        if (N == 128) transpose_stage<128>((const u32*)raw.data(), (u32*)copy.data(), warp, lane);
        if (N == 64) transpose_stage<64>((const u32*)raw.data(), (u32*)copy.data(), warp, lane);
      }
    for (int n = 0; n < N; ++n)
      for (int k = 0; k < KB; ++k) lhs[n * KB + k] = (signed char)copy[4 * sw128_word(n, k) + (k & 3)];
  }
  const int pad_plane = fake ? 0 : -128;
  std::vector<u32> W(kvalid * L);
  for (auto& v : W) scanf("%u", &v);
  std::vector<long long> P((long long)N * 4 * L, 0);
  int bad_pad_plane = 0;
  for (int o0 = 0; o0 < L; o0 += wt) {
    // the stage's word tile as TMA writes it: zero words past the ends; an
    // int64 lane's high half (0xDEADBEEF here) is never read
    std::vector<u32> ws(KB * wt * wstride, 0xDEADBEEFu);
    for (int r = 0; r < KB; ++r)
      for (int col = 0; col < wt; ++col) {
        const bool in = r < kvalid && o0 + col < L;
        ws[swz ? w_index_sw(r, col) : w_index(r, col, wt, wstride)] = in ? W[r * L + o0 + col] : 0u;
      }
    for (int sub = 0; sub < wt / WSUB; ++sub) {
      // one consumer warpgroup: its 64 plane-column rows x 128 k
      static int A[64][KB];
      for (int w = 0; w < 4; ++w)
        for (int lane = 0; lane < 32; ++lane) {
          const int col = frag_col(sub, w, lane);
          for (int ks = 0; ks < KB / 32; ++ks) {
            u32 a[4];
            if (fake && swz) {
              plane_frags<FRAG_FAKE, true>(a, ws.data(), wt, wstride, col, ks, lane);
            } else if (fake) {
              plane_frags<FRAG_FAKE>(a, ws.data(), wt, wstride, col, ks, lane);
            } else if (swz) {
              plane_frags<FRAG_SIGNED, true>(a, ws.data(), wt, wstride, col, ks, lane);
            } else {
              plane_frags<FRAG_SIGNED>(a, ws.data(), wt, wstride, col, ks, lane);
            }
            for (int r = 0; r < 4; ++r)
              for (int i = 0; i < 4; ++i) {
                const int m = 16 * w + (lane >> 2) + 8 * (r & 1);
                const int v = (signed char)((a[r] >> (8 * i)) & 0xFF);
                A[m][32 * ks + frag_k(lane, r, i)] = v;
                if (o0 + col >= L && v != pad_plane) ++bad_pad_plane;
              }
          }
        }
      // D = A x lhs^T, then the accumulator registers' stores
      for (int w = 0; w < 4; ++w)
        for (int lane = 0; lane < 32; ++lane)
          for (int j = 0; j < N / 2; ++j) {
            const int m = 16 * w + (lane >> 2) + 8 * ((j >> 1) & 1);
            const int n = acc_row(lane, j);
            long long d = 0;
            for (int k = 0; k < KB; ++k) d += (long long)A[m][k] * lhs[n * KB + k];
            const int word = o0 + WSUB * sub + acc_word(w, lane);
            if (word < L) P[(long long)n * 4 * L + acc_plane(lane, j) * L + word] = d;
          }
    }
  }
  printf("%d\n", bad_pad_plane);
  for (long long v : P) printf("%lld ", v);
  printf("\n");
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the fragment header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("plane_frags")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
        check=True, capture_output=True, text=True,
    )
    return str(exe)


@pytest.mark.parametrize("wt,wstride,L,kvalid,N,mode,kmajor,swz", [
    # int64 lanes, one row group's words: a full tile and a ragged one
    pytest.param(32, 2, 45, 128, 48, "full", False, False, id="32-2-45-128-48"),
    # BabyBear's L, a slice ending inside the stage
    pytest.param(16, 2, 63, 100, 64, "full", False, False, id="16-2-63-100-64"),
    pytest.param(16, 2, 72, 128, 32, "full", False, False, id="16-2-72-128-32"),  # Frog's L
    pytest.param(32, 1, 7, 37, 16, "full", False, False, id="32-1-7-37-16"),  # u32 words, fewer words than one warp's
    # u32 words as the kernel stages them, rows swizzled (w_index_sw)
    pytest.param(32, 1, 45, 128, 224, "full", False, True, id="swz-32-1-45-128-224"),
    # the dot-only probe's fake planes (P1 kern_dot_only): u32 words, int64 lanes
    pytest.param(32, 1, 45, 128, 224, "dot_only", False, True, id="dot_only-swz-32-1-45-128-224"),
    pytest.param(32, 2, 20, 77, 64, "dot_only", False, False, id="dot_only-32-2-20-77-64"),
    # the K-major lhs (P3 kmajor_kernel): each row-group width N that
    # plane_commit.sm90_groups takes (the probe's Mpad gives 224)
    pytest.param(32, 1, 40, 128, 224, "full", True, True, id="kmajor-swz-32-1-40-128-224"),
    pytest.param(32, 1, 51, 128, 192, "full", True, True, id="kmajor-swz-32-1-51-128-192"),
    pytest.param(32, 2, 29, 111, 128, "full", True, False, id="kmajor-32-2-29-111-128"),
    pytest.param(32, 2, 33, 90, 64, "full", True, False, id="kmajor-32-2-33-90-64"),
])
def test_fragments_and_accumulators_match_plain_planes(harness, wt, wstride, L, kvalid, N, mode, kmajor, swz):
    rng = np.random.default_rng(wt * 1009 + L * 31 + kvalid)
    lhs = rng.integers(-128, 128, size=(N, KB), dtype=np.int64)
    lhs[:, kvalid:] = 0  # TMA zero-fills the Ajtai tile past the slice
    words = rng.integers(0, 1 << 32, size=(kvalid, L), dtype=np.uint64)
    words[0, 0], words[-1, -1] = 0, (1 << 32) - 1
    text = (f"{wt} {wstride} {L} {kvalid} {N} {int(mode == 'dot_only')} {int(kmajor)} {int(swz)}\n"
            + " ".join(map(str, lhs.ravel())) + "\n" + " ".join(map(str, words.ravel())))
    out = subprocess.run([harness], input=text + "\n", capture_output=True, text=True, check=True).stdout.split("\n")
    assert int(out[0]) == 0  # every plane of a word past L reads -128 (fake planes: 0)
    got = np.array(out[1].split(), dtype=np.int64).reshape(N, 4 * L)
    a = torch.from_numpy(lhs[None, :, :kvalid]).to(torch.int8)
    if kmajor:
        a = a.transpose(1, 2).contiguous()  # [c, Ks, Mpad]
    want = tpc.plane_dot_plain(a, torch.from_numpy(words.astype(np.int64))[None], mode, kmajor).numpy()[0]
    assert np.array_equal(got, want)
