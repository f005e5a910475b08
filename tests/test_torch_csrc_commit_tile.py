"""The Hopper commit kernel's block algorithm
(latticefold_torch/csrc/commit_sm90.cuh, the phases and index maps that
csrc/commit_sm90_kernel.cu runs) against the plain commit,
``mxu.ajtai_commit_plain``, on the CPU; and its plan,
``mxu.commit_sm90_plan``, at every shape chip_smoke.py times.

The header compiles as plain C++ too (field_common.cuh), so a small
harness built with g++ runs every block of the kernel's pass-1 grid, one
thread at a time per phase, in the order the kernel's barriers impose:
stage 0, then per stage t the copies of stage t + 1 into the other buffer
before the products of stage t; then the lanes' tree (the partner of a
lane at each level is the one the shuffle gives), then the partial sums'
store. Then every block of pass 2: each thread's sum over chunks, their
sum, one reduction per coefficient and the y^(e+k) fold. Shared memory
starts as garbage, the partials and the output as -1 words.

The cases: every (nl, e) at kappa 1 and 2 with Nb 1, 2 and 3, kappa 1 with
Nb 5 and kappa 3 with Nb 5 (the last k and b tiles ragged where the
register tile is 2 wide; f read from device memory where one tile spans
k, else staged), at n of a few hundred with the plan's chunk shrunk (an SM
count of 1 or 2) so that two or four chunks run and the last stage of each
is ragged; and at Nb 5 the pair groups cut to one tile each, so that
blocks start at b (and k) other than 0, and with 2 and 4 pass-2 warps an
output. A mutation of ``swz``, ``row``,
``coords``, the stage's, the direct loads' or the store's index maps that
misses a word or sends two to one place fails it; so does one of the lazy
sums' carry chains (their host form). The copies, the barriers, the
shuffles and the launch are the card's: chip_smoke.py holds the kernel
against the plain commit and the first commit kernel there, at every shape
it times. ``ajtai_commit_plain`` itself is held against the JAX package by
tests/test_torch_commit.py.

Tolerance: exact equality -- every value is an integer mod q."""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from latticefold_torch import cuda, params
from latticefold_torch.commitment import AjtaiScheme
from latticefold_torch.rings import mxu, ops
from latticefold_torch.rings.construct import get_ring

OPT_IN_SMEM = 232448  # shared memory a block may opt in to on an H100 (227 KB)
MAX_GRID_Y = 65535

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "commit_sm90.cuh"

using namespace cm90;

template <class T>
static std::vector<T> load(const char* dir, const char* name, size_t n) {
  std::vector<T> v(n);
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "rb");
  if (!f || fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "cannot read %s\n", path);
    std::exit(1);
  }
  fclose(f);
  return v;
}

template <class F, int E, int KT, int BT, bool DF>
static int run(const char* dir, Problem pr, const u64* consts) {
  typedef Block<F, E, KT, BT, DF> B;
  typedef Finish<F, E> Fin;
  typedef typename F::Elem Elem;
  typedef typename F::Acc Acc;
  constexpr int S = 2 * E - 1, W = sizeof(Acc) / 8, NL = F::NL;
  const size_t row = (size_t)pr.ncomp * E * NL;
  const auto A = load<long long>(dir, "A.bin", (size_t)pr.kappa * pr.n * row);
  const auto f = load<long long>(dir, "f.bin", (size_t)pr.n * pr.Nb * row);
  const auto red = E > 1 ? load<long long>(dir, "red.bin", (size_t)(E - 1) * E * NL) : std::vector<long long>(1);
  const int P = pr.kappa * pr.Nb;
  std::vector<u64> partial((size_t)pr.nchunks * pr.ncomp * P * S * W, ~0ull);
  std::vector<long long> out((size_t)P * row, -1);
  pr.A = A.data();
  pr.f = f.data();
  pr.red = red.data();
  pr.partial = partial.data();
  pr.out = out.data();
  const F fld = F::from(consts);
  const int nth = B::threads(pr);
  fprintf(stderr, "%zu %d %d\n", B::smem_bytes(pr), nth, groups<KT, BT>(pr));
  std::vector<u64> smem((B::smem_bytes(pr) + 7) / 8);
  std::vector<typename B::Regs> regs(nth);
  std::vector<typename B::Sums> sums(nth), prev(nth);
  for (int ch = 0; ch < pr.nchunks; ++ch)
    for (int g = 0; g < groups<KT, BT>(pr); ++g) {
      for (auto& w : smem) w = 0xA5A5A5A5A5A5A5A5ull;
      const B blk(pr, g, ch, reinterpret_cast<unsigned char*>(smem.data()));
      for (auto& r : regs) B::zero(r);
      const int ns = blk.stages();
      if (ns > 0)
        for (int t = 0; t < nth; ++t) blk.stage(0, 0, t, nth);
      for (int s = 0; s < ns; ++s) {
        if (s + 1 < ns)
          for (int t = 0; t < nth; ++t) blk.stage((s + 1) & 1, s + 1, t, nth);
        for (int t = 0; t < nth; ++t) blk.mac_rows(s & 1, s, t, regs[t]);
      }
      for (int t = 0; t < nth; ++t) B::sums(regs[t], sums[t]);
      for (int o = pr.lanes / 2; o >= 1; o >>= 1) {
        prev = sums;
        for (int t = 0; t < nth; ++t)
          for (int kk = 0; kk < KT; ++kk)
            for (int bb = 0; bb < BT; ++bb)
              for (int s = 0; s < S; ++s) acc_add(sums[t].acc[kk][bb][s], prev[t ^ o].acc[kk][bb][s]);
      }
      for (int t = 0; t < nth; ++t) blk.write_partial(t, sums[t]);
    }
  const Fin fin{pr};
  const int per_block = FINISH_THREADS / WARP / pr.fwarps;
  for (int blk = 0; blk < Fin::blocks(pr); ++blk)
    for (int wp = 0; wp < FINISH_THREADS / WARP; wp += pr.fwarps) {  // an output's first warp
      int c, p, sub;
      if (!Fin::coords(pr, blk, wp, c, p, sub)) continue;
      Acc tot[S];
      for (int s = 0; s < S; ++s) F::zero(tot[s]);
      for (int t = 0; t < pr.fwarps * WARP; ++t) {  // its threads' sums, added (the trees' order is immaterial)
        Acc acc[S];
        fin.chunk_sum(c, p, t, pr.fwarps * WARP, acc);
        for (int s = 0; s < S; ++s) acc_add(tot[s], acc[s]);
      }
      Elem v[S];
      for (int s = 0; s < S; ++s) v[s] = fld.reduce(tot[s]);  // lane s reduces coefficient s
      for (int t = 0; t < E; ++t) fin.store(c, p, t, fin.fold(fld, v[t], v, t));
    }
  (void)per_block;
  fwrite(out.data(), sizeof(long long), out.size(), stdout);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  int nl, e, kt, bt, direct, nc;
  Problem pr{};
  if (scanf("%d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d", &nl, &e, &kt, &bt, &direct, &pr.kappa, &pr.n,
            &pr.Nb, &pr.ncomp, &pr.kg, &pr.bg, &pr.lanes, &pr.tn, &pr.chunk, &pr.nchunks, &pr.fwarps, &nc) != 17)
    return 2;
  u64 c[16];
  for (int i = 0; i < nc; ++i) scanf("%llu", &c[i]);
#define LF_RUN(FT, EE, KT, BT)                                                                       \
  if (nl == FT::NL && e == EE && kt == KT && bt == BT)                                             \
    return direct ? run<FT, EE, KT, BT, true>(argv[1], pr, c) : run<FT, EE, KT, BT, false>(argv[1], pr, c);
  LF_RUN(F32, 9, 1, 1)
  LF_RUN(F64, 3, 1, 1)
  LF_RUN(F64, 4, 2, 1)
  LF_RUN(F64, 4, 1, 1)
  LF_RUN(F256, 1, 1, 2)
  LF_RUN(F256, 1, 2, 1)
  LF_RUN(F256, 1, 1, 1)
  return 3;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the commit kernel's header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("commit_tile")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", cuda.CSRC, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    return str(exe)


def rand_limbs(ring, shape, seed):
    """Uniform canonical F_q values as int64 limb tensors [*shape, nl]."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (ring.nl,), dtype=np.uint64)
    limbs[..., -1] %= np.uint64(ring.q >> (32 * (ring.nl - 1)))
    return torch.from_numpy(limbs.astype(np.int64))


def run_blocks(harness, tmp_path, ring, matrix, f, plan):
    """Every block of both passes at ``plan``; returns (out, smem, threads,
    groups) as the header computes them."""
    kappa, n = matrix.shape[:2]
    Nb = f.shape[1]
    matrix.numpy().tofile(tmp_path / "A.bin")
    f.numpy().tofile(tmp_path / "f.bin")
    red = ops.red_rows(ring, torch.device("cpu"))
    if red is not None:
        red.numpy().astype(np.int64).tofile(tmp_path / "red.bin")
    words = list(cuda.field_constants(ring.q, ring.nl))
    head = [ring.nl, ring.e, plan.kt, plan.bt, plan.direct, kappa, n, Nb, ring.ncomp, plan.kg, plan.bg, plan.lanes,
            plan.tn, plan.chunk, plan.nchunks, plan.fwarps, len(words)]
    run = subprocess.run([harness, str(tmp_path)], input=(" ".join(map(str, head + words)) + "\n").encode(),
                         capture_output=True, check=True)
    smem, threads, groups = map(int, run.stderr.split())
    got = torch.from_numpy(np.frombuffer(run.stdout, dtype=np.int64).copy()).reshape(kappa, Nb, ring.ncomp,
                                                                                      ring.e, ring.nl)
    return got, smem, threads, groups


SHAPES = [(1, 1), (1, 2), (1, 3), (1, 5), (2, 1), (2, 2), (2, 3), (3, 5)]  # (kappa, Nb)


@pytest.mark.parametrize("kappa,Nb", SHAPES, ids=[f"k{k}b{b}" for k, b in SHAPES])
@pytest.mark.parametrize("name", ["babybear", "goldilocks", "frog", "stark"])
def test_commit_blocks_match_plain(harness, tmp_path, name, kappa, Nb):
    ring = get_ring(name)
    n = 300 if kappa * Nb < 15 else 170
    scheme = AjtaiScheme(ring, kappa, n, seed=5 + kappa, device="cpu")
    f = rand_limbs(ring, (n, Nb, ring.ncomp, ring.e), seed=10 * kappa + Nb)
    want = mxu.ajtai_commit_plain(ring, scheme.matrix, f)
    sms = 1 if Nb % 2 else 2  # two chunks, or four
    plan = mxu.commit_sm90_plan(ring, kappa, n, Nb, sms)
    assert plan.nchunks >= 2 and plan.chunk % plan.tn != 0
    got, smem, threads, groups = run_blocks(harness, tmp_path, ring, scheme.matrix, f, plan)
    assert (smem, threads, groups) == (plan.smem, plan.threads, plan.groups)
    assert torch.equal(got, want), (name, kappa, Nb, int((got != want).sum()))
    if Nb == 5:  # one tile a group: blocks at b (and k) other than 0; rings of 2 and 4 buffers
        for other in (plan._replace(kg=1, bg=1), plan._replace(fwarps=2), plan._replace(fwarps=4)):
            got, _, _, groups = run_blocks(harness, tmp_path, ring, scheme.matrix, f, other)
            if (other.kg, other.bg) == (1, 1):
                assert groups == -(-kappa // plan.kt) * -(-Nb // plan.bt) > 1
            assert torch.equal(got, want), (name, other, int((got != want).sum()))


def _chip_smoke_shapes():
    """(ring, kappa, n, Nb) of every commit chip_smoke.py times: bench.py's
    b16 / b64, two slices, each fold at Nb = K - 1 and 1 (b 16 and the
    big-m fold at theirs), LatticeFold+'s eight and its small fixture's."""
    shapes = [("goldilocks", 9, 1 << 15, 16), ("goldilocks", 9, 1 << 15, 64), ("goldilocks", 9, 1 << 16, 16)]
    folds = {"goldilocks": (params.DP_GOLDILOCKS, 9), "frog": (params.DP_FROG, 12),
             "babybear": (params.DP_BABYBEAR, 6), "stark": (params.DP_STARK_E2E, 17)}
    for name, (dp, kappa) in folds.items():
        shapes += [(name, kappa, 4096 * dp.L, dp.K - 1), (name, kappa, 4096 * dp.L, 1)]
    shapes += [("goldilocks", 9, 4096 * params.DP_GOLDILOCKS_B16.L, params.DP_GOLDILOCKS_B16.K - 1),
               ("goldilocks", 9, 32768 * params.DP_GOLDILOCKS.L, params.DP_GOLDILOCKS.K - 1)]
    shapes += [("frog", 2, 1 << 15, Nb) for Nb in (1, 2, 3, 32)] + [("frog", 1, 1 << 15, Nb) for Nb in (1, 2, 3, 64)]
    shapes += [("frog", 1, 1 << 13, Nb) for Nb in (1, 2, 3, 16)]
    return shapes


@pytest.mark.parametrize("name,kappa,n,Nb", _chip_smoke_shapes(),
                         ids=[f"{r}-k{k}-n{n}-b{b}" for r, k, n, b in _chip_smoke_shapes()])
def test_commit_sm90_plan_is_legal(name, kappa, n, Nb):
    """The plan at the card's 132 SMs: two stage buffers within the 227 KB a
    block may opt in to (and within the plan's own budget), a block of at
    most 256 threads in whole warps, a legal grid, chunks that cover n, and
    lanes a power of two within a warp and a stage; at P = 2 no idle warp
    (every thread owns an item's lane)."""
    ring = get_ring(name)
    pl = mxu.commit_sm90_plan(ring, kappa, n, Nb, sms=132)
    assert (pl.kt, pl.bt) in mxu._SM90_TILES[(ring.nl, ring.e)] and pl.kt <= kappa and pl.bt <= Nb
    assert pl.direct == (kappa <= pl.kt)
    assert pl.smem == 2 * (pl.kg * pl.kt + (0 if pl.direct else pl.bg * pl.bt)) * pl.tn * mxu._pitch_bytes(ring)
    assert pl.fwarps in (1, 2, 4, 8) and (pl.fwarps == 8 or 32 * pl.fwarps >= pl.nchunks)
    assert pl.smem <= min(OPT_IN_SMEM, mxu._SM90_SMEM)
    wide = not pl.direct and (pl.kt, pl.bt) == (1, 1) and ring.nl >= 2
    assert pl.threads % 32 == 0 and 32 <= pl.threads <= (mxu._SM90_WIDE_THREADS if wide else mxu._SM90_THREADS)
    items = ring.ncomp * pl.kg * pl.bg
    assert items * pl.lanes <= pl.threads < items * pl.lanes + 32
    assert pl.lanes & (pl.lanes - 1) == 0 and pl.lanes <= min(32, pl.tn)
    ktiles, btiles = -(-kappa // pl.kt), -(-Nb // pl.bt)
    assert pl.groups == -(-ktiles // pl.kg) * -(-btiles // pl.bg)
    assert 1 <= pl.nchunks <= MAX_GRID_Y and pl.groups * pl.nchunks >= 132
    assert (pl.nchunks - 1) * pl.chunk < n <= pl.nchunks * pl.chunk
    if kappa * Nb == 2:
        assert pl.threads == items * pl.lanes


@pytest.mark.parametrize("name", ["goldilocks", "frog", "babybear", "stark"])
def test_commit_sm90_plan_no_idle_warp_at_p2(name):
    """P = kappa Nb = 2 (LatticeFold+'s smallest commit, kappa 2 at Nb 1 and
    kappa 1 at Nb 2) fills every thread of the block for every ring."""
    ring = get_ring(name)
    for kappa, Nb in ((2, 1), (1, 2)):
        pl = mxu.commit_sm90_plan(ring, kappa, 1 << 15, Nb, sms=132)
        assert pl.threads == ring.ncomp * pl.kg * pl.bg * pl.lanes >= 128
        assert pl.lanes <= pl.tn


LAZY_HARNESS = r"""
#include <cstdio>
#include "commit_sm90.cuh"

using namespace cm90;

// reads nl, then count pairs of nl-limb values (u32 words, least first);
// prints the words of the field Acc of their lazy sum
template <class F>
static int run(int count) {
  typedef Lazy<F> LZ;
  typename LZ::T v;
  LZ::zero(v);
  for (int m = 0; m < count; ++m) {
    long long x[F::NL], y[F::NL];
    for (int i = 0; i < F::NL; ++i) scanf("%lld", &x[i]);
    for (int i = 0; i < F::NL; ++i) scanf("%lld", &y[i]);
    LZ::mac(v, F::load(x), F::load(y));
  }
  typename F::Acc a;
  LZ::acc(v, a);
  const u64* w = reinterpret_cast<const u64*>(&a);
  for (size_t i = 0; i < sizeof(a) / 8; ++i) printf("%llu\n", w[i]);
  return 0;
}

int main() {
  int nl, count;
  if (scanf("%d %d", &nl, &count) != 2) return 2;
  if (nl == 1) return run<F32>(count);
  if (nl == 2) return run<F64>(count);
  if (nl == 8) return run<F256>(count);
  return 3;
}
"""


@pytest.fixture(scope="module")
def lazy_harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the commit kernel's header cannot be compiled on the host")
    d = tmp_path_factory.mktemp("commit_lazy")
    (d / "lazy.cpp").write_text(LAZY_HARNESS)
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", cuda.CSRC, "-o", str(d / "lazy"), str(d / "lazy.cpp")],
                   check=True, capture_output=True, text=True)
    return str(d / "lazy")


@pytest.mark.parametrize("nl", [1, 2, 8])
def test_lazy_sums_take_every_carry(lazy_harness, nl):
    """The lazy sums (``Lazy<F>``, the host form of the card's carry chains)
    of products whose limbs are all ones, then of random ones, equal the
    exact sum: every chain's last carry, which random limbs almost never
    raise, is taken on the way. Exact equality against Python integers."""
    rng = np.random.default_rng(nl)
    top = (1 << 31) - 1 if nl == 1 else (1 << 32) - 1  # F32's values are below 2^31
    pairs = [([top] * nl, [top] * nl)] * 300
    pairs += [(list(map(int, rng.integers(0, top + 1, nl))), list(map(int, rng.integers(0, top + 1, nl))))
              for _ in range(300)]
    text = f"{nl} {len(pairs)}\n" + "\n".join(" ".join(map(str, x + y)) for x, y in pairs) + "\n"
    run = subprocess.run([lazy_harness], input=text.encode(), capture_output=True, check=True)
    words = [int(w) for w in run.stdout.split()]
    got = sum(w << (64 * i) for i, w in enumerate(words))

    def value(limbs):
        return sum(v << (32 * i) for i, v in enumerate(limbs))

    assert got == sum(value(x) * value(y) for x, y in pairs)
