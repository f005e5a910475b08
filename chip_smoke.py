#!/usr/bin/env python3
"""Drive latticefold_torch's main paths on one NVIDIA GPU and check them.

  python3 chip_smoke.py   # every path, about 14 min of command time

The paths: one NIFS fold per ring through ``nifs.prove`` / ``nifs.verify``,
on the identity R1CS of wit_len 4096, x_len 1, with a witness of ones and
Ajtai seed 7 on the standard (non-big-m) path:

  goldilocks  DP_GOLDILOCKS  kappa 9   the repo's fold sweep's first row
  frog        DP_FROG        kappa 12  the smallest kappa that
  babybear    DP_BABYBEAR    kappa 6   params.check_ring_modulus_128_bits_security
  stark       DP_STARK_E2E   kappa 17  accepts at wit_len 4096

Frog's fold runs its counted prove only (no timed prove): it is there so
that the kernels run at its shapes (nl 2, e 4, d 16) on a path.

Phases (any failure raises and the script exits non-zero):

1. Print the card (name, and name + power limit from nvidia-smi), build
   both CUDA kernels from ``latticefold_torch/csrc`` with nvcc (one process
   per source, in parallel; every field-width instance is in them) and
   print the build seconds.
2. For each ring, hold each kernel against its plain PyTorch version on the
   card at the path's shapes: the CRT kernel as icrt at N = wit_len (the
   input witness), crt at N = n = wit_len * L (each digit witness) and icrt
   at N = n (the folded witness); the commit kernel at (kappa, n) with
   Nb = K - 1 and Nb = 1. Exact equality (all values are integers mod q).
   The plain commit runs in chunks of n added with ``mo.add`` (the same
   function; Stark's full product would need tens of GB). Print each
   kernel's median ms, the plain version's ms and the bound: the larger of
   the bytes the function moves (4 nl bytes per F_q value, each input read
   once, each output written once) over the card's memory rate, and the
   32-bit multiply-adds it needs (two per 32x32 -> 64 limb product, nl^2
   limb products per F_q product) over the card's 32-bit rate outside the
   tensor cores.
3. For each ring's fold: one prove with the launch counts reset just before
   it (crt 2K + 1 and commit 2 launches per prove, checked), timing the
   host transcript sponge; the port's verifier must accept its proof and
   the folded witness must open the folded commitment; then the timed
   proves, which must give the same proof; and the tests' small fixture
   folded on the card must give the same proof as on the CPU. The native
   (C++) Poseidon sponge must have built for the rings with q < 2^64. Peak
   device memory is printed. One more Stark prove runs under the profiler
   (device busy s, device kernels, idle share; about 5 min in all, most of
   it spent stopping the profiler and reading ~3 million events).
4. Print the ``kernels`` JSON line (one entry per kernel and ring), then the
   card line, then the last line ``{"ok": true, "device": {...}}``.

Without a card, or without the ``latticefold_torch`` package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit multiply-adds per second outside the tensor cores: the H100 SXM's
# 67 TFLOP/s float32 rate counts an FMA as two operations; the card's integer
# multiply-adds issue at no higher rate, so this bound is never too high
PEAK_MAD32_PER_S = 33.5e12
PLAIN_CHUNK_BYTES = 1 << 30  # largest product tensor of the chunked plain commit

WIT_LEN = 4096
X_LEN = 1
# ring -> (preset, kappa, timed proves after the counted one); in this order
PATHS = {
    "goldilocks": ("DP_GOLDILOCKS", 9, 2),
    "frog": ("DP_FROG", 12, 0),
    "babybear": ("DP_BABYBEAR", 6, 1),
    "stark": ("DP_STARK_E2E", 17, 1),
}
PROFILED = "stark"  # the ring whose fold runs one more prove under the profiler


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


T0 = time.perf_counter()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rand_field(ring, shape, seed, device):
    """Uniform canonical F_q values as int64 limb tensors [*shape, nl] (valid
    Montgomery values too), made on the host from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (ring.nl,), dtype=np.uint64)
    top = ring.q >> (32 * (ring.nl - 1))  # below q: the top limb below q's
    limbs[..., -1] %= np.uint64(top)
    return torch.from_numpy(limbs.astype(np.int64)).to(device)


def time_ms(fn, reps, flush=None):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events); the
    L2 cache is flushed before each run so inputs come from HBM."""
    import torch

    ts = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def bound(ring, n_values: int, n_products: int) -> dict:
    """Least time for work that moves ``n_values`` F_q values and does
    ``n_products`` F_q products: the larger of the byte and operation
    times."""
    bytes_ms = n_values * 4 * ring.nl / PEAK_BYTES_PER_S * 1e3
    mad32 = 2 * ring.nl**2 * n_products
    ops_ms = mad32 / PEAK_MAD32_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, mad32=mad32)


def commit_plain(ring, matrix, f):
    """The plain commit over chunks of n, added mod q: the same function as
    ``mxu.ajtai_commit_plain`` with product tensors of at most
    PLAIN_CHUNK_BYTES."""
    from latticefold_torch import modops as mo
    from latticefold_torch.rings import mxu

    kappa, n = matrix.shape[0], matrix.shape[1]
    per_n = kappa * f.shape[1] * ring.ncomp * ring.e * ring.nl * 8
    step = max(1, PLAIN_CHUNK_BYTES // per_n)
    out = None
    for s in range(0, n, step):
        part = mxu.ajtai_commit_plain(ring, matrix[:, s : s + step], f[s : s + step])
        out = part if out is None else mo.add(ring.fq, out, part)
    return out


def check_kernels(name, dp, scheme, device):
    """Phase 2 for one ring: each kernel against its plain version at the
    path's shapes. Returns {(kernel, shape): numbers}."""
    import torch

    from latticefold_torch.rings import mxu, ops

    ring = scheme.ring
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)  # > 50 MB L2
    results = {}
    n = scheme.n
    for which, N, seed in (("icrt", WIT_LEN, 1), ("crt", n, 2), ("icrt", n, 5)):
        x = rand_field(ring, (N, ring.d), seed, device)
        mat = ops._device_mat(ring, which, device)
        got = ops._transform_kernel(ring, which, x)
        want = ops.mat_apply(ring.fq, mat, x)
        torch.cuda.synchronize()
        err = int((got != want).sum().item())
        if err:
            raise AssertionError(f"crt kernel [{name}] ({which}, N={N}): {err} limbs differ from the plain version")
        ms = time_ms(lambda: ops._transform_kernel(ring, which, x), 20, flush)
        plain_ms = time_ms(lambda: ops.mat_apply(ring.fq, mat, x), 3, flush)
        b = bound(ring, 2 * N * ring.d, N * ring.d * ring.d)
        results[("crt", f"{which} N={N}")] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0, **b)
        log(f"[kernels] crt_kernel[{name}] {which} N={N}: {ms:.4f} ms  plain {plain_ms:.2f} ms  "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; bytes {b['bytes_ms']:.4f}, "
            f"{b['mad32']:.3e} mad32 {b['ops_ms']:.4f})  exact")
        del x, got, want

    kappa = scheme.kappa
    for Nb, seed in ((dp.K - 1, 3), (1, 4)):
        f = rand_field(ring, (n, Nb, ring.ncomp, ring.e), seed, device)
        got = mxu._commit_kernel(ring, scheme.matrix, f)
        want = commit_plain(ring, scheme.matrix, f)
        torch.cuda.synchronize()
        err = int((got != want).sum().item())
        if err:
            raise AssertionError(f"commit kernel [{name}] (Nb={Nb}): {err} limbs differ from the plain version")
        del want
        ms = time_ms(lambda: mxu._commit_kernel(ring, scheme.matrix, f), 10, flush)
        plain_ms = time_ms(lambda: commit_plain(ring, scheme.matrix, f), 1, flush)
        b = bound(ring, (kappa * n + n * Nb + kappa * Nb) * ring.ncomp * ring.e,
                  kappa * Nb * ring.ncomp * n * ring.e**2)
        results[("commit", f"kappa={kappa} n={n} Nb={Nb}")] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=0, **b)
        log(f"[kernels] commit_kernel[{name}] kappa={kappa} n={n} Nb={Nb}: {ms:.4f} ms  "
            f"plain {plain_ms:.2f} ms  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
            f"{b['bytes_ms']:.4f}, {b['mad32']:.3e} mad32 {b['ops_ms']:.4f})  exact")
        del f, got
    del flush
    torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def sponge_timer(sponge_cls, acc: dict):
    """Adds the host seconds spent in the transcript sponge's public calls
    to ``acc["s"]`` while the block runs (outermost calls only)."""
    names = ("absorb", "squeeze_native", "squeeze_bytes")
    saved = {k: getattr(sponge_cls, k) for k in names}
    depth = [0]

    def wrap(fn):
        def timed(self, *args, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    acc["s"] += time.perf_counter() - t0
        return timed

    for k, fn in saved.items():
        setattr(sponge_cls, k, wrap(fn))
    try:
        yield acc
    finally:
        for k, fn in saved.items():
            setattr(sponge_cls, k, fn)


def small_fold(name, device):
    """The tests' small fixture (kappa = 4, seed 7) for ``name`` folded on
    ``device``; returns (proof, folded)."""
    import latticefold_torch.nifs as nifs
    import latticefold_torch.nifs.linearization as linearization
    from latticefold_torch import params
    from latticefold_torch.arith.ccs import CCCS, CCS, get_test_r1cs, get_test_z_split
    from latticefold_torch.arith.witness import Witness
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.rings import ops
    from latticefold_torch.rings.construct import get_ring
    from latticefold_torch.transcript import Transcript

    dp = getattr(params, PATHS[name][0])
    ring = get_ring(name)
    ccs = CCS.from_r1cs_padded(ring, get_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = get_test_z_split(ring, 3)
    scheme = AjtaiScheme(ring, 4, len(w_host) * dp.L, seed=7, device=device)
    wit = Witness.from_w_ccs(ring, dp, ops.to_device(ring, w_host, device), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = linearization.prove(cm_i, wit, Transcript(ring), ccs)
    folded, _, proof = nifs.prove(acc, wit, cm_i, wit, Transcript(ring), ccs, scheme, dp)
    return proof, folded


def run_fold(name, dp, scheme, reps, device, profile=False):
    """Phase 3 for one ring: the fold at WIT_LEN, X_LEN, as
    benches/sweep_e2e.py sets it up. Returns a dict of results; raises on
    any failed check."""
    import torch

    import latticefold_torch.nifs as nifs
    import latticefold_torch.nifs.linearization as linearization
    from latticefold_torch import cuda
    from latticefold_torch.arith.ccs import CCCS, CCS, get_test_dummy_r1cs
    from latticefold_torch.arith.witness import Witness
    from latticefold_torch.native import NativeSponge
    from latticefold_torch.rings import ops
    from latticefold_torch.transcript import Transcript

    ring = scheme.ring
    sponge_cls = type(Transcript(ring).sponge)
    # prove seconds depend on which sponge runs: hold the 64-bit fields to
    # the C++ one (q > 2^64 has only the Python sponge, in both packages)
    if ring.q < 1 << 64 and sponge_cls is not NativeSponge:
        raise AssertionError("the native Poseidon sponge did not build or load (g++ on PATH?)")
    t0 = time.perf_counter()
    r1cs = get_test_dummy_r1cs(ring, X_LEN, WIT_LEN, X_LEN + WIT_LEN + 1)
    ccs = CCS.from_r1cs_padded(ring, r1cs, W=X_LEN + WIT_LEN + 1, L=dp.L)
    wit = Witness.from_w_ccs(ring, dp, ops.to_device(ring, [ring.one()] * WIT_LEN, device), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=[ring.one()] * X_LEN)
    acc, _ = linearization.prove(cm_i, wit, Transcript(ring), ccs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[fold {name}] wit_len={WIT_LEN} m={ccs.m} n={scheme.n} kappa={scheme.kappa}: setup "
        f"{setup_s:.2f} s ({sponge_cls.__name__})")

    def prove():
        return nifs.prove(acc, wit, cm_i, wit, Transcript(ring), ccs, scheme, dp)

    # the main path, counted: every kernel of the path must launch in it,
    # as often as the code says (2K crt + 1 icrt, 2 commits)
    torch.cuda.reset_peak_memory_stats(device)
    cuda.reset_launches()
    sponge = {"s": 0.0}
    t0 = time.perf_counter()
    with sponge_timer(sponge_cls, sponge):
        folded, w0, proof = prove()
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    log(f"[fold {name}] first prove {first_s:.3f} s (host sponge {sponge['s']:.3f} s); launches {launches}")
    expected = {"crt": 2 * dp.K + 1, "commit": 2}
    if launches != expected:
        raise AssertionError(f"launches per prove {launches}, expected {expected}")

    t0 = time.perf_counter()
    folded_v = nifs.verify(acc, cm_i, proof, Transcript(ring), ccs, dp)
    verify_s = time.perf_counter() - t0
    if (folded_v.r, folded_v.v, folded_v.u, folded_v.cm) != (folded.r, folded.v, folded.u, folded.cm):
        raise AssertionError("verifier's folded accumulator differs from the prover's")
    if w0.commit(scheme) != folded.cm:
        raise AssertionError("the folded witness does not open the folded commitment")
    log(f"[fold {name}] verify {verify_s:.3f} s: verifier accepts; w0 opens the folded commitment")

    prove_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, _, again = prove()
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
        if again != proof:
            raise AssertionError("a timed prove gave another proof")
    peak = torch.cuda.max_memory_allocated(device)
    log(f"[fold {name}] timed prove s {prove_s}; peak device memory {peak} B")
    out = dict(m=ccs.m, n=scheme.n, kappa=scheme.kappa, setup_s=setup_s, first_prove_s=first_s,
               sponge_s=sponge["s"], prove_s=prove_s, verify_s=verify_s, peak_bytes=peak,
               launches=launches)
    if profile:
        out["profile"] = profile_prove(name, prove)
    return out


def profile_prove(name, prove):
    """One more prove under torch.profiler (device activity only): device
    busy time (sum of kernel durations on the one stream) against the wall
    clock, the number of device kernels, and the top kernels by device time
    (written to chiprun_out/chip_smoke_profile_<ring>.txt). The raw kineto
    events are read directly: building the profiler's event tree for ~10^6
    kernels takes minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_stop = time.perf_counter()
    stop_s = time.perf_counter() - t_stop
    t0 = time.perf_counter()
    busy_ns = 0
    n_kernels = 0
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        dur = e.duration_ns()
        busy_ns += dur
        n_kernels += 1
        n, t = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (n + 1, t + dur)
    busy = busy_ns / 1e9
    read_s = time.perf_counter() - t0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{name}.txt"), "w") as fh:
        fh.write(f"wall {wall:.4f} s  device busy {busy:.4f} s  kernels {n_kernels}\n")
        for kname, (n, ns) in top:
            fh.write(f"{ns / 1e6:12.3f} ms {n:8d}x  {kname[:150]}\n")
    out = dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
               device_kernels=n_kernels, stop_s=stop_s, read_s=read_s,
               top=[dict(name=k[:80], count=n, ms=ns / 1e6) for k, (n, ns) in top[:8]])
    log(f"[profile {name}] prove under the profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {out['idle_share']:.3f}), {n_kernels} device kernels; stopping the "
        f"profiler {stop_s:.1f} s, reading its events {read_s:.1f} s")
    return out


KERNEL_INFO = {
    "crt": dict(
        name="crt_kernel", route="cuda", source="latticefold_torch/csrc/crt_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_crt.py:105",
    ),
    "commit": dict(
        name="commit_kernel", route="cuda", source="latticefold_torch/csrc/commit_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_commit.py:136,179",
    ),
}


def kernel_entries(name, dp, kappa, kres, launches):
    """The ``kernels`` JSON entries of one ring: each kernel at the shape the
    prove launches it at (crt at N = n, the commit at Nb = K - 1), with the
    other shapes beside it."""
    n = WIT_LEN * dp.L
    entries = []
    for key, main in (("crt", f"crt N={n}"), ("commit", f"kappa={kappa} n={n} Nb={dp.K - 1}")):
        r = kres[(key, main)]
        info = dict(KERNEL_INFO[key])
        info["name"] = f"{info['name']}[{name}]"
        entries.append(dict(
            info, ring=name, launches=launches[key], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape=main,
            other_shapes={s: v for (k, s), v in kres.items() if k == key and s != main},
        ))
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from latticefold_torch import cuda, params
        from latticefold_torch.commitment import AjtaiScheme
        from latticefold_torch.rings.construct import get_ring
    except ImportError as e:
        print(f"chip_smoke: the latticefold_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())

    # phase 1: the card and the build
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    built = cuda.build()
    log(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'up to date'} "
        f"(wall {time.perf_counter() - t0:.1f} s, parallel nvcc)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as fh:
        for k, v in cuda.BUILD_LOG.items():
            fh.write(f"== {k}\n{v}\n")

    record = dict(card=smi, wit_len=WIT_LEN, rings={})
    entries = []
    # phases 2 and 3, one ring after the other
    for name, (preset, kappa, reps) in PATHS.items():
        dp = getattr(params, preset)
        ring = get_ring(name)
        scheme = AjtaiScheme(ring, kappa, WIT_LEN * dp.L, seed=7, device=device)
        kres = check_kernels(name, dp, scheme, device)
        fold = run_fold(name, dp, scheme, reps, device, profile=name == PROFILED)
        proof_card, folded_card = small_fold(name, device)
        proof_cpu, folded_cpu = small_fold(name, torch.device("cpu"))
        if proof_card != proof_cpu or folded_card.cm != folded_cpu.cm:
            raise AssertionError(f"small fold [{name}]: the card's proof differs from the CPU's")
        log(f"[fold {name}] small fixture: the card's proof equals the CPU's")
        record["rings"][name] = dict(kernels={f"{k}:{s}": v for (k, s), v in kres.items()}, fold=fold)
        entries += kernel_entries(name, dp, kappa, kres, fold["launches"])
        del scheme
        torch.cuda.empty_cache()

    # phase 4: the record
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
