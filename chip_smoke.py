#!/usr/bin/env python3
"""Drive latticefold_torch's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py    # the full-width fold (wit_len 4096, kappa 9)

Phases (any failure raises and the script exits non-zero):

1. Print the card (name, and name + power limit from nvidia-smi), build both
   CUDA kernels from ``latticefold_torch/csrc`` with nvcc (in parallel) and
   print the build seconds.
2. Hold each kernel against its plain PyTorch version on the card, on the
   main path's shapes: the CRT kernel as icrt at N = 4096 (the input
   witness), crt at N = 20480 (each digit witness) and icrt at N = 20480
   (the folded witness), the commit kernel at kappa = 9, n = 20480 with
   Nb = 14 and Nb = 1. Exact equality (all values are integers mod q). Print each
   kernel's median ms, the plain version's ms and the bound: the bytes the
   function moves, 8 B per F_q element (each input read once, each output
   written once), over the card's memory rate.
3. Fold: the identity R1CS of wit_len 4096, x_len 1 (CCS rows m = 2^15,
   Ajtai width n = 20480), kappa = 9, DP_GOLDILOCKS, random-free witness of
   ones, with the native (C++) Poseidon sponge, which must have built. One
   prove with the launch counts reset just before it (each kernel must have
   launched), then two timed proves; the port's verifier must accept, the
   folded witness must open the folded commitment, and a small fold on the
   card must give the same proof as the same fold on the CPU.
4. Print the ``kernels`` JSON line, then the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Without a card, or without the ``latticefold_torch`` package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FQ_BYTES = 8  # one F_q element (q < 2^64) as the function needs it

# the main path: the repo's fold sweep's first row (benches/sweep_e2e.py)
WIT_LEN = 4096
X_LEN = 1
KAPPA = 9


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rand_field(ring, shape, seed, device):
    """Uniform canonical F_q values as int64 limb tensors (valid Montgomery
    values too), made on the host from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64, endpoint=False) % np.uint64(ring.q)
    limbs = np.stack([v & np.uint64(0xFFFFFFFF), v >> np.uint64(32)], axis=-1)
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


def bound_ms(n_fq: int) -> float:
    """Least time to move ``n_fq`` F_q elements at the card's memory rate."""
    return n_fq * FQ_BYTES / PEAK_BYTES_PER_S * 1e3


def check_kernels(ring, device):
    """Phase 2: each kernel against its plain version at the path's shapes."""
    import torch

    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.params import DP_GOLDILOCKS as dp
    from latticefold_torch.rings import mxu, ops

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)  # > 50 MB L2
    results = {}
    n = WIT_LEN * dp.L  # Ajtai width = length of a digit / folded witness

    # CRT kernel: icrt of w_ccs (N = wit_len), crt of f_coeff (N = n) and
    # icrt of the folded f (N = n)
    for which, N, seed in (("icrt", WIT_LEN, 1), ("crt", n, 2), ("icrt", n, 5)):
        x = rand_field(ring, (N, ring.d), seed, device)
        got = ops._transform_kernel(ring, which, x)
        want = ops.mat_apply(ring.fq, ops._device_mat(ring, which, device), x)
        torch.cuda.synchronize()
        err = int((got != want).sum().item())
        if err:
            raise AssertionError(f"crt kernel ({which}, N={N}): {err} limbs differ from the plain version")
        ms = time_ms(lambda: ops._transform_kernel(ring, which, x), 20, flush)
        plain_ms = time_ms(
            lambda: ops.mat_apply(ring.fq, ops._device_mat(ring, which, device), x), 3, flush
        )
        bound = bound_ms(2 * N * ring.d)  # N elements in, N out
        results[(which, N)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=0)
        log(f"[kernels] crt_kernel {which} N={N}: {ms:.4f} ms  plain {plain_ms:.2f} ms  "
            f"bound {bound:.4f} ms (bytes)  exact")
        del x, got, want

    # commit kernel: Nb = K - 1 (decomposition) and 1 (commit_device)
    kappa = KAPPA
    scheme = AjtaiScheme(ring, kappa, n, seed=7, device=device)
    for Nb, seed in ((dp.K - 1, 3), (1, 4)):
        f = rand_field(ring, (n, Nb, ring.ncomp, ring.e), seed, device)
        got = mxu._commit_kernel(ring, scheme.matrix, f)
        want = mxu.ajtai_commit_plain(ring, scheme.matrix, f)
        torch.cuda.synchronize()
        err = int((got != want).sum().item())
        if err:
            raise AssertionError(f"commit kernel (Nb={Nb}): {err} limbs differ from the plain version")
        ms = time_ms(lambda: mxu._commit_kernel(ring, scheme.matrix, f), 10, flush)
        plain_ms = time_ms(lambda: mxu.ajtai_commit_plain(ring, scheme.matrix, f), 2, flush)
        bound = bound_ms((kappa * n + n * Nb + kappa * Nb) * ring.ncomp * ring.e)
        results[("commit", Nb)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, max_abs_err=0)
        log(f"[kernels] commit_kernel kappa={kappa} n={n} Nb={Nb}: {ms:.4f} ms  "
            f"plain {plain_ms:.2f} ms  bound {bound:.4f} ms (bytes)  exact")
        del f, got, want
    del flush
    torch.cuda.empty_cache()
    return results


def small_fold(device):
    """The tests' small fixture (Goldilocks, kappa = 4, seed 7), folded on
    ``device``; returns (acc, proof, folded)."""
    import latticefold_torch.nifs as nifs
    import latticefold_torch.nifs.linearization as linearization
    from latticefold_torch.arith.ccs import CCCS, CCS, get_test_r1cs, get_test_z_split
    from latticefold_torch.arith.witness import Witness
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.params import DP_GOLDILOCKS as dp
    from latticefold_torch.rings import ops
    from latticefold_torch.rings.construct import get_ring
    from latticefold_torch.transcript import Transcript

    ring = get_ring("goldilocks")
    ccs = CCS.from_r1cs_padded(ring, get_test_r1cs(ring), W=4, L=dp.L)
    _, x_ccs, w_host = get_test_z_split(ring, 3)
    scheme = AjtaiScheme(ring, 4, len(w_host) * dp.L, seed=7, device=device)
    wit = Witness.from_w_ccs(ring, dp, ops.to_device(ring, w_host, device), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc, _ = linearization.prove(cm_i, wit, Transcript(ring), ccs)
    folded, _, proof = nifs.prove(acc, wit, cm_i, wit, Transcript(ring), ccs, scheme, dp)
    return acc, proof, folded


def run_fold(device, reps: int = 2):
    """Phase 3: the fold at WIT_LEN, X_LEN, KAPPA, as benches/sweep_e2e.py
    sets it up. Returns a dict of results; raises on any failed check."""
    import torch

    import latticefold_torch.nifs as nifs
    import latticefold_torch.nifs.linearization as linearization
    from latticefold_torch import cuda
    from latticefold_torch.arith.ccs import CCCS, CCS, get_test_dummy_r1cs
    from latticefold_torch.arith.witness import Witness
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.native import NativeSponge
    from latticefold_torch.params import DP_GOLDILOCKS as dp
    from latticefold_torch.rings import ops
    from latticefold_torch.rings.construct import get_ring
    from latticefold_torch.transcript import Transcript

    ring = get_ring("goldilocks")
    # prove seconds depend on which sponge runs: hold the fold to the C++ one
    if not isinstance(Transcript(ring).sponge, NativeSponge):
        raise AssertionError("the native Poseidon sponge did not build or load (g++ on PATH?)")
    wit_len, x_len, kappa = WIT_LEN, X_LEN, KAPPA
    t0 = time.perf_counter()
    r1cs = get_test_dummy_r1cs(ring, x_len, wit_len, x_len + wit_len + 1)
    ccs = CCS.from_r1cs_padded(ring, r1cs, W=x_len + wit_len + 1, L=dp.L)
    scheme = AjtaiScheme(ring, kappa, wit_len * dp.L, seed=7, device=device)
    wit = Witness.from_w_ccs(ring, dp, ops.to_device(ring, [ring.one()] * wit_len, device), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=[ring.one()] * x_len)
    acc, _ = linearization.prove(cm_i, wit, Transcript(ring), ccs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"[fold] wit_len={wit_len} m={ccs.m} n={scheme.n} kappa={kappa}: setup {setup_s:.2f} s "
        "(native Poseidon sponge)")

    # the main path, counted: every kernel of the path must launch in it
    torch.cuda.reset_peak_memory_stats(device)
    cuda.reset_launches()
    t0 = time.perf_counter()
    folded, w0, proof = nifs.prove(acc, wit, cm_i, wit, Transcript(ring), ccs, scheme, dp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    log(f"[fold] first prove {first_s:.3f} s; launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    prove_s, verify_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        folded, w0, proof = nifs.prove(acc, wit, cm_i, wit, Transcript(ring), ccs, scheme, dp)
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        folded_v = nifs.verify(acc, cm_i, proof, Transcript(ring), ccs, dp)
        verify_s.append(time.perf_counter() - t0)
        if (folded_v.r, folded_v.v, folded_v.u, folded_v.cm) != (folded.r, folded.v, folded.u, folded.cm):
            raise AssertionError("verifier's folded accumulator differs from the prover's")
    peak = torch.cuda.max_memory_allocated(device)
    if w0.commit(scheme) != folded.cm:
        raise AssertionError("the folded witness does not open the folded commitment")
    log(f"[fold] prove s {[round(s, 4) for s in prove_s]}  verify s "
        f"{[round(s, 4) for s in verify_s]}  peak device memory {peak} B; "
        "verifier accepts; w0 opens the folded commitment")
    return dict(m=ccs.m, n=scheme.n, setup_s=setup_s, first_prove_s=first_s,
                prove_s=prove_s, verify_s=verify_s, peak_bytes=peak, launches=launches,
                profile=profile_prove(
                    lambda: nifs.prove(acc, wit, cm_i, wit, Transcript(ring), ccs, scheme, dp)
                ))


def profile_prove(prove):
    """One more prove under torch.profiler (device activity only): device
    busy time (sum of kernel durations on the one stream) against the wall
    clock, the number of device kernels, and the top kernels by device time
    (written to chiprun_out/chip_smoke_profile.txt). The raw kineto events
    are read directly: building the profiler's event tree for ~10^6 kernels
    takes minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as fh:
        fh.write(f"wall {wall:.4f} s  device busy {busy:.4f} s  kernels {n_kernels}\n")
        for name, (n, ns) in top:
            fh.write(f"{ns / 1e6:12.3f} ms {n:8d}x  {name[:150]}\n")
    out = dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
               device_kernels=n_kernels,
               top=[dict(name=k[:80], count=n, ms=ns / 1e6) for k, (n, ns) in top[:8]])
    log(f"[profile] prove under the profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {out['idle_share']:.3f}), {n_kernels} device kernels")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from latticefold_torch import cuda
        from latticefold_torch.params import DP_GOLDILOCKS as dp
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

    ring = get_ring("goldilocks")

    # phase 2: every kernel against its plain version on the path's shapes
    kres = check_kernels(ring, device)

    # phase 3: the fold, and a small fold held against the CPU
    fold = run_fold(device)
    _, proof_card, folded_card = small_fold(device)
    _, proof_cpu, folded_cpu = small_fold(torch.device("cpu"))
    if proof_card != proof_cpu or folded_card.cm != folded_cpu.cm:
        raise AssertionError("small fold: the card's proof differs from the CPU's")
    log("[fold] small fixture: the card's proof equals the CPU's")

    # phase 4: the record
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=smi, kernels={f"{k[0]}:{k[1]}": v for k, v in kres.items()},
                       fold=fold, wit_len=WIT_LEN, kappa=KAPPA), fh, indent=1)
    n = WIT_LEN * dp.L
    entries = []
    for key, main_shape, others in (
        ("crt", ("crt", n), [("icrt", WIT_LEN), ("icrt", n)]),
        ("commit", ("commit", dp.K - 1), [("commit", 1)]),
    ):
        r = kres[main_shape]
        entries.append(dict(
            KERNEL_INFO[key], launches=fold["launches"][key], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=None, shape=f"{main_shape[0]}:{main_shape[1]}",
            other_shapes={f"{o[0]}:{o[1]}": kres[o] for o in others},
        ))
    log(json.dumps({"kernels": entries}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
