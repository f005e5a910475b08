#!/usr/bin/env python3
"""Drive latticefold_torch's main paths on one NVIDIA GPU and check them.

  python3 chip_smoke.py              # every path, about 14 min of command time
  python3 chip_smoke.py --profile    # and one more Stark prove under the profiler (about 3 min)
  python3 chip_smoke.py --plus-sweep # instead: LatticeFold+ over PLUS_SWEEP (about 17 min)

The paths: one NIFS fold per ring through ``nifs.prove`` / ``nifs.verify``,
on the identity R1CS of wit_len 4096, x_len 1, with a witness of ones and
Ajtai seed 7 on the standard path (the port's rule must choose it there):

  goldilocks  DP_GOLDILOCKS  kappa 9   the repo's fold sweep's first row
  frog        DP_FROG        kappa 12  the smallest kappa that
  babybear    DP_BABYBEAR    kappa 6   params.check_ring_modulus_128_bits_security
  stark       DP_STARK_E2E   kappa 17  accepts at wit_len 4096

Each fold runs its counted prove only (no timed prove; Stark's profiled
prove only with ``--profile``), to leave room in the time limit for
phases 3b-4; Frog's is there so that the kernels run at its shapes (nl 2,
e 4, d 16) on a path. The CPU halves of the card-against-CPU checks (the
small fixtures of phases 3 and 4c) run in one worker process, started
after the build, while the card works; the script stops it before it
exits.

Phases (any failure raises and the script exits non-zero):

1. Print the card (name, and name + power limit from nvidia-smi), build
   every CUDA kernel from ``latticefold_torch/csrc`` with nvcc (one process
   per source, in parallel; every field-width instance is in them) and
   print the build seconds.
1b. The byte-plane batch commit (``AjtaiScheme.commit_batch_fused``, the
   fold's batch commit: kernel A's Hopper dot ``plane_dot_sm90_kernel.cu``
   once per 2^15-term slice, and kernel B, the diagonal epilogue
   ``plane_epilogue_diag_kernel.cu``, once), driven with the launch counts
   reset just before each call and checked just after:
   - at bench.py's headline shape (Goldilocks, kappa 9, n 2^15, seed 1,
     seeded witness batches Nb = 16 and 64), at two slices (the same ring
     and kappa, n 2^16, Nb 16: two kernel A launches, one kernel B launch
     with nsl 2) and at each fold's commit shape (the fold phase's
     kappa, n = wit_len L, Nb = K - 1, for every ring, for phase 3c's
     preset and for phase 3d's wit_len 32768: five kernel A launches, one
     kernel B launch with nsl 5): equal to ``commit_batch_cm`` (the
     Hopper commit kernel) and, at bench.py's shape, to the plain byte-plane
     route (``mxu.ajtai_commit_cm``); the Hopper commit kernel
     (``commit_sm90_kernel.cu``) equal to the first commit kernel
     (``commit_kernel.cu``, off every path) and, at bench.py's shapes and
     two slices, to the plain commit, the three (and the route) timed in
     turns and its two passes timed apart (``commit_turns``); the Hopper dot, the mma.sync dot and
     kernel B each equal to their plain versions, kernel B also to the
     item-per-thread kernel ``plane_epilogue_kernel.cu`` (off the path);
     ms and commits/s of both routes; the Hopper dot's ms (twice) beside
     the mma.sync dot's from the same call, its bound (4 B a word), its
     lane floor (8 B a word, the int64 limb lanes it reads) and
     ``_int_mm``; kernel B's ms timed in turns with the item-per-thread
     kernel's;
   - a contiguous BabyBear batch with odd Nb (rows of 63 words, not 16
     bytes apart) through ``commit_batch_fused``, which copies it into
     aligned storage first: equal to ``commit_batch_cm``;
   - the TPU probes P1-P5 (``rings/plane_probes.py``) at their TPU shapes,
     each equal to its plain version, timed beside its bound and, where one
     PyTorch call computes the same function, that call (``torch._int_mm``
     for the int8 dots it accepts, 8 calls for the 8-component dots, with B
     as given, N-contiguous, and handed column-major); P1 v1 runs the
     mma.sync dot, P1 v2, dot_only, P2 batched and P3 kmajor the Hopper dot,
     P4 and P5 dot_u8 kernel C's Hopper GEMM (``int_gemm_sm90_kernel.cu``,
     one launch, no clearing of C), P5 dot_u8_via_bf16 kernel C's bf16
     instance on Hopper (``bf16_gemm_sm90_kernel.cu``, one launch);
     each Hopper kernel of P1 dot_only, P3 and P4 / P5 dot_u8 timed in turns
     with its first design (``plane_dot_mma``, ``int_gemm_mma``), which
     must equal the plain version too, on the device and for the host's
     time a call (``host_us_in_turns``); P5 dot_u8_via_bf16 (``bf16_case``)
     equal to the plain version, as is its first design (``bf16_gemm_mma``,
     ``int_gemm_kernel.cu``), at 128 x 128 x 128, a ragged 72 x 200 x 40
     and all-255 operands at K 256, and timed in turns with the first
     design and ``torch.mm`` of the bf16 casts with a float32
     ``out_dtype`` (exact here; ``bf16_mm_fn``) over 1000 launches each;
     P5 bitcast and merge (kernel D's vector copies) equal to their first
     design (``bitcast_u8_v1``, ``merge_minor_v1``) and timed in turns with
     it and ``clone()`` over 1000 launches each (``probe_turns``).
2. For each ring, hold each kernel against its plain PyTorch version on the
   card at the path's shapes: the tensor-core CRT kernel
   (``crt_tc_kernel.cu``) as icrt at N = wit_len (the input witness), crt
   at N = n = wit_len * L (each digit witness) and icrt at N = n (the
   folded witness), against both plain versions (``ops.mat_apply`` and
   ``ops.crt_conv_plain``, on the conv matrix the kernel reads) and the
   SIMT CRT kernel (``crt_kernel.cu``, off the main path), timed beside it
   in the same call, with ``torch._int_mm`` of signed operands at the conv
   dot's M x K x columns as a yardstick of the dot half (not the same
   function); the Hopper commit kernel at (kappa, n) with Nb = K - 1 and
   Nb = 1 against the plain commit, the first commit kernel and the
   byte-plane route (``commit_turns``: all timed in turns, its passes apart).
   Exact equality (all values are integers mod q). The plain commit runs
   in chunks of n added with ``mo.add`` (the same function; Stark's full
   product would need tens of GB). Print each kernel's median ms, the
   plain version's ms and the bound: the larger of the bytes the function
   moves (4 nl bytes per F_q value, each input read once, each output
   written once) over the card's memory rate, and its operations over the
   card's rate for their type: for the tensor-core CRT the byte products
   the function needs (d^2 (4 nl)^2 per element, two operations each) at
   the int8 tensor-core rate, with the lane floor (8 B a limb, the int64
   lanes) beside it; for the SIMT CRT and the commit kernels the 32-bit
   multiply-adds (two per 32x32 -> 64 limb product, nl^2 limb products per
   F_q product) at the card's 32-bit rate outside the tensor cores (the
   commit kernels' lane floor beside it). The Poseidon sponge kernel
   (``poseidon_kernel.cu`` ``lf_poseidon_sponge``, one launch per absorb
   or squeeze call of the device transcript) against its plain version
   (``transcript.device.sponge_call_plain``, ``permute_plain`` between the
   call's segments) on the card: one permutation, a chunk at rate index
   POSEIDON_IDX, a multi-permutation absorb and a multi-permutation
   squeeze; its first design (``lf_poseidon``, a permutation a launch, off
   every path) against ``permute_plain``; a mixed absorb / squeeze schedule
   of the device sponge on the card against the same on the CPU (resting
   at index == rate, switching modes, a challenge, a short challenge); the
   one-permutation call timed in turns with the first design, cold L2 and
   warm, and a permutation inside absorbs of the provers' round-message
   lengths (warm), beside the bound and the latency bound
   (``check_poseidon``, ``poseidon_chains_ms``: the launch floor of a
   one-element fill timed in the call, or the permutation's own chain of
   dependent multiply-adds at 4 cycles each and the card's maximum SM
   clock, with the first design's figure beside it).
3. For each ring's fold: one prove with the launch counts reset just before
   it (the tensor-core CRT 2K + 1, the Hopper dot 2 and the diagonal
   epilogue 2 launches per prove, and no other kernel: the SIMT CRT, the
   item-per-thread epilogue and both commit kernels 0; checked), timing the
   host
   transcript sponge; the port's verifier must accept its proof and the
   folded witness must open the folded commitment; then the timed proves,
   which must give the same proof; one decomposition batch committed by
   the Hopper commit kernel must give the proof's batch commitments; the tests'
   small fixture folded on the card must give the same proof and folded
   accumulator bytes (``serialization.serialize_proof`` /
   ``serialize_lcccs``) as on the CPU, for Goldilocks over a two-step
   chain (both steps' proofs). Frog's fold runs once more through
   ``nifs.device_step.DeviceNIFS`` (``run_device_nifs``): its device part
   under ``torch.cuda.set_sync_debug_mode("error")``, its launches counted
   (the tensor-core CRT 4K + 4, the Hopper dot 2, the diagonal epilogue 2,
   the Poseidon sponge kernel once per absorb call and per squeeze call
   that permutes of its device sponge, ``device_sponge_calls``; the
   kernel's permutations, ``cuda.PERMUTATIONS``, equal to its schedule's
   and to the counted prove's host transcript's), and its proof bytes,
   folded accumulator, witness and transcript state equal to the counted
   prove's. The native
   (C++) Poseidon sponge must have built for the rings with q < 2^64. Peak
   device memory is printed. With ``--profile``, one more Stark prove runs
   under the profiler (device busy s, device kernels, idle share; about 3
   min in all, most of it spent stopping the profiler and reading ~3
   million events).
3b. The IVC chain of ``latticefold_torch.e2e`` (``run_chain``'s parts:
   ``setup_chain``, ``fold_steps``, ``prove_step``) on Goldilocks at
   DP_GOLDILOCKS with the fold phase's instance (wit_len 4096, x_len 1,
   kappa 9, Ajtai seed 7): 2 steps, each folding the fresh instance into
   the accumulator of the step before (its host transcript's permutations
   counted). Each step's prove is counted on its
   own and must launch the tensor-core CRT 31, the Hopper dot 2 and the
   diagonal epilogue 2 times and nothing else; step 1's proof bytes must
   equal the fold phase's counted prove's; every proof and accumulator
   must survive serialize -> deserialize -> serialize; the verifier
   replays the steps from the bootstrap accumulator and must reach the
   prover's accumulator after each; w_2 must open acc_2.cm; and step 2,
   proved again from the serialized acc_1 and w_1's digits
   (``serialize_lcccs``, ``serialize_witness_f``,
   ``Witness.from_f_coeff``), must give the same proof bytes (its host
   syncs counted, sync debug mode "warn"). Recorded: each step's prove
   seconds, proof bytes (raw and zlib), peak device memory and the memory
   held at its start; the verify seconds. Then 3e.
3e. The chain of 3b through ``DeviceNIFS`` (``e2e.setup_chain(...,
   fused=True)``): each step's device part under sync debug mode "error",
   its host syncs counted, its launches those of Frog's DeviceNIFS fold
   with this step's permutations, and its proof bytes, folded
   accumulator, witness and transcript state equal to 3b's step (step 1's
   proof is the fold phase's); prove s beside 3b's.
3c. Moderate b: Goldilocks at DP_GOLDILOCKS_B16 (b 16, K 4, a degree-32
   folding sumcheck) on the fold phase's instance: one counted prove
   (the tensor-core CRT 2K + 1 = 9, the Hopper dot 2, the diagonal
   epilogue 2, nothing else), verified, w0 opens, prove s and peak
   recorded. The small fixtures at DP_GOLDILOCKS_B16 (62 s of card and
   CPU) and DP_STARK_FOLDING (140.9 s on the card) are left out for the
   time limit (PERF.md section 4; slow-marked CPU tests hold their bytes
   against the JAX prover).
3d. Big m: the fold phase's Goldilocks instance forced onto the big-m
   path (``big_m=True, expand_nvars=13``: J = 2 W-tensor rounds), whose
   proof bytes must equal the fold phase's counted prove's, its peak
   printed beside the standard path's; then Goldilocks at wit_len 32768
   (the repo sweep's row: m 2^18, n 163840, J = 5) through
   ``latticefold_torch.e2e`` with no path asked for: phase 2's kernel
   checks at its shapes, then one counted prove on the path the port's
   rule chooses, which must be the big-m one (the tensor-core CRT 31, the
   Hopper dot 10: five slices for each of the 2 batch commits, the
   diagonal epilogue 2, nothing else), verified, w0 opens, peak device
   memory under 90 % of the card's, prove s, verify s, peak and the
   memory held at its start recorded.
4. LatticeFold+ (``latticefold_torch.plus``) on Frog; its sumchecks take
   ``plus.sumcheck.prove_device`` on the card, each round loop under sync
   debug mode "error"; every prove is counted and must launch the
   tensor-core CRT L + 3 + (n_lin + 2) log n times for L folded instances
   of which n_lin are new (an ICRT of each round message of the ring-mode
   sumchecks), the Hopper commit kernel L (g + 1) + 1 times (g groups of
   at most 4 GiB of monomial columns in each instance's range check: 1
   at every shape of the default run, 2-3 at the sweep's n 2^19 points
   at k 3-5) and the Poseidon
   sponge kernel once per absorb call and per squeeze call that permutes
   of the device sumchecks' schedules (three a round; its permutations
   those of the schedules), and nothing else (the first commit kernel 0; ``ComR1CS.new``: 2 and 1);
   each records prove s, the host seconds in the sponge, in the
   subprotocols and in the costliest host loops (t(z), the split into
   tau, comh, the transpose products, the sparse matrices' ELL build),
   peak and reserved device memory and each part's peak:
   4a. The JAX package's bench at its TPU defaults (``PLUS_BENCH``: n
       2^15, k 2, kappa 2, the identity R1CS, z all ones, Ajtai seed 7):
       the Hopper commit kernel against the plain commit, the first commit
       kernel and the byte-plane route at kappa 2, n 2^15 and Nb 1, 2, 3
       and 32 (the path's commit shapes; the CRT's shapes are the Frog
       fold's, held in phase 2), all timed in turns, its passes apart;
       ``commit_batch_fused`` (kernels A and B, off this path) counted and
       against the Hopper commit kernel at the same shapes, then one prove
       (L = 1), the port's verifier on a fresh
       transcript, verify s and proof bytes (raw and zlib); then the same
       prove on a fresh prover with the host-transcript sumchecks
       (``prove_host``: crt_tc L + 3, no Poseidon kernel), which must give
       the same bytes, its seconds and parts recorded beside (the pairs
       in turns, medians of three, run under ``--plus-sweep``).
   4b. The reference's accumulation test (``PLUS_MULTI``: n 2^15, k 4,
       kappa 1): the same kernel checks at Nb 1, 2, 3 and 64, then 3
       rounds on one prover (L = 3 from round 2), each verified by one
       verifier that carries its transcript across rounds; round 3's peak
       within PLUS_PEAK_NOISE of round 2's.
   4c. The tests' small fixture (``PLUS_SMALL``: n 2^13, k 1) proved on
       the card (verified) and on the CPU: equal ``serialize_plus_proof``
       bytes, whose SHA-256 is the JAX prover's (``PLUS_SMALL_SHA256``).
   4d. The JAX bench's defaults at the top of the reference sweep
       (``PLUS_TOP``: n 2^19, k 2, kappa 2, L 1): the tensor-core CRT
       against both plain versions at icrt N = m = 2^18, crt and icrt N =
       2^19 and the Hopper commit kernel as in 4a at kappa 2, n 2^19, Nb
       1, 2, 3 and 32; one counted prove (crt_tc 61, commit_sm90 3),
       verified, its serialization round trip, its peak under 0.9 of the
       card.
   4e. (``PLUS_K3``: n 2^15, k 3, kappa 1, two instances in one round;
       m k < n, so ``ComR1CS.new`` pads f): the commit kernel held at Nb
       k d = 48, one counted prove, verified, whose bytes must hash to the
       JAX prover's (``PLUS_K3_SHA256``).
   With ``--plus-sweep`` instead of the paths: ``plus_peak_sweep``, every
   point of ``PLUS_SWEEP`` (n 2^15-2^19 at k 2, kappa 2, L 1; at n 2^19
   L 2, 3, 8, (k, kappa) = (3, 3), (4, 4), (5, 5) at L 1 and (5, 5) at
   L 8) proved as 4d is, a point that runs out of device memory recorded
   as such, the commit kernel held at kappa 5, n 2^19 and each Nb the
   prover gives it there (``PLUS_SWEEP_COMMIT``), then 4a's provers in
   turns (``plus_bench_turns``); written to
   chiprun_out/chip_smoke_plus_peaks.json.
5. Print the ``kernels`` JSON line (also written to
   chiprun_out/chip_smoke_kernels.json; one entry per kernel and fold path,
   the DeviceNIFS paths of Frog's fold and of 3e's step 1 included, the
   SIMT CRT, the item-per-thread epilogue and both commit kernels marked
   off the fold paths, the Poseidon kernels off the modular ones (its first design off every path), the CRT and
   both commit kernels for 4a and 4b (4b
   with round 2's launches; the first commit kernel at 0), per kernel, mode
   and shape of phase 1b, and both commit kernels at bench.py's shapes and
   two slices), then
   the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Without a card, or without the ``latticefold_torch`` package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
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
PEAK_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core operations (a MAC is two)
PEAK_BF16_OPS_PER_S = 989e12
WARM_SLEEP_CYCLES = 400_000  # a warm timed run: the card sleeps this long (about 0.2 ms) while the host enqueues
PLAIN_CHUNK_BYTES = 1 << 30  # largest product tensor of the chunked plain commit
CPU_WAIT_S = 900  # longest wait for a CPU half of a check (the worker may have died)

WIT_LEN = 4096
X_LEN = 1
# ring -> (preset, kappa, timed proves after the counted one); in this order
PATHS = {
    "goldilocks": ("DP_GOLDILOCKS", 9, 0),
    "frog": ("DP_FROG", 12, 0),
    "babybear": ("DP_BABYBEAR", 6, 0),
    "stark": ("DP_STARK_E2E", 17, 0),
}
PROFILED = "stark"  # with --profile, the ring whose fold runs one more prove under the profiler
CPU_WORKER_THREADS = 4  # torch threads of the worker that makes the CPU halves of the checks
# the IVC chain (latticefold_torch.e2e): ring, kappa and steps at WIT_LEN,
# X_LEN, with the fold phase's instance; the step after which it is
# checkpointed and resumed; the steps of the small fixture's chain
CHAIN = ("goldilocks", 9, 2)
CHAIN_RESUME_AFTER = 1
SMALL_CHAIN_STEPS = 2
# phase 3: the ring whose fold also runs once through DeviceNIFS (phase 3e
# runs the chain's ring, CHAIN[0], that way)
DEVICE_NIFS_FOLD = "frog"
# phase 3c, moderate b: the fold phase's instance of this ring and kappa at
# this preset (its small fixtures are left out for the time limit, PERF.md
# section 4)
MODERATE_B = ("goldilocks", "DP_GOLDILOCKS_B16", 9)
# phase 3d, big m: the fold phase's Goldilocks instance forced onto the
# big-m path with this expand_nvars (J = log m - it W-tensor rounds), then
# the repo sweep's wit_len 32768 row (benches/sweep_e2e.py:54-62: kappa 9,
# x_len 1, seed 7; m 2^18, n 163840) through latticefold_torch.e2e, where
# the path rule must choose the big-m path
BIGM_EXPAND_NVARS = 13
BIGM = ("goldilocks", 32768, 9)
PEAK_SHARE_MAX = 0.9  # a fold's peak device memory must stay under this share of the card's
# phase 4, LatticeFold+ (latticefold_torch.plus) on Frog (q < 2^64: the C++
# sponge). 4a: the JAX package's bench at its TPU defaults
# (benches/run.py:253-264): n, k, kappa; b = d/2, l = 22,
# B = estimate_bound(d 128, 3, d, k) + 1, the identity R1CS through
# r1cs_decomposed_square, z all ones, Ajtai seed 7
PLUS_BENCH = (1 << 15, 2, 2)
# 4b: the reference's test_prove_multi (tests/test_plus.py:346-379): n, k,
# kappa, rounds on one prover; B = estimate_bound(d 128, 3, d, k) // 2
PLUS_MULTI = (1 << 15, 4, 1, 3)
PLUS_PEAK_NOISE = 0.01  # 4b: round 3's peak may exceed round 2's by this share
# 4c: tests/test_plus.py's small fixture, _plus_setup(n=2^13, k=1) (kappa 1),
# and the SHA-256 of the JAX prover's serialize_plus_proof bytes for it
# (tests/test_torch_plus.py's JAX_PLUS_E2E_SHA256)
PLUS_SMALL = (1 << 13, 1, 1)
PLUS_SMALL_SHA256 = "a155fe6c1293ac985ca3b7752773dfffe2fcccb7dd9014b8046dfc8ace221bf0"
# 4d: 4a's instance at the top of the reference sweep (witness 32K-512K:
# latticefold-plus/benches/utils/mod.rs:25-50, SURVEY.md section 6), the JAX
# bench's BENCH_PLUS_N = 2^19 at its default k 2, kappa 2: n, k, kappa (L 1)
PLUS_TOP = (1 << 19, 2, 2)
# 4e: n, k, kappa, L instances in one round; m = n // k, f padded to n by
# ComR1CS.new; B = estimate_bound(d 128, 3, d, k) + 1; and the SHA-256 of
# the JAX prover's serialize_plus_proof bytes there (tests/test_torch_plus_scale.py)
PLUS_K3 = (1 << 15, 3, 1, 2)
PLUS_K3_SHA256 = "20893643c7db97542263d3f81eb3a360326860e15cf51205885aa62a4d74182a"
# --plus-sweep: (n, k, kappa, L) over the reference sweep's ranges (witness
# 32K-512K, k 2-5, kappa 2-5, L 2-8: SURVEY.md section 6), on 4a's instance
PLUS_SWEEP = (
    [(1 << e, 2, 2, 1) for e in range(15, 20)]
    + [(1 << 19, 2, 2, L) for L in (2, 3, 8)]
    + [(1 << 19, k, k, 1) for k in (3, 4, 5)]
    + [(1 << 19, 5, 5, 8)]
)
# the commit kernel's Nb at (kappa 5, n 2^19): decompose's 2, from_f's rest 3,
# and its monomial columns' groups (k d = 80 in groups of mf_group_cols = 32)
PLUS_SWEEP_COMMIT = (2, 3, 16, 32)
# bench.py's headline commit (bench.py:114-151): ring, kappa, n, Ajtai seed, batches
BENCH_COMMIT = ("goldilocks", 9, 1 << 15, 1, (16, 64))
# the two-slice batch commit: bench.py's ring, kappa and Nb 16 at n 2^16
TWO_SLICE_COMMIT = ("goldilocks", 9, 1 << 16, 16)
PROBE_C, PROBE_MPAD, PROBE_K = 8, 224, 1 << 15  # the probes' commit-dot shape
POSEIDON_IDX = 7  # phase 2: the rate index at which the timed permutation's chunk is added
# phase 2: the sumcheck degrees whose round messages ((degree + 1) d values)
# the Poseidon kernel's absorbs are timed at (LatticeFold+'s 2 and 3, the
# linearization's 3; the fold's 2b is added per ring)
PROVER_ABSORB_DEGREES = (2, 3)


def log(msg):
    """Print a timestamped line, and append it to chiprun_out/chip_smoke_run.log
    once that directory exists (the whole log, which the end of the output
    may not hold)."""
    line = f"[{time.perf_counter() - T0:7.1f} s] {msg}"
    print(line, flush=True)
    if os.path.isdir(OUT_DIR):
        with open(os.path.join(OUT_DIR, "chip_smoke_run.log"), "a") as fh:
            fh.write(line + "\n")


T0 = time.perf_counter()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rand_field(ring, shape, seed, device):
    """Uniform canonical F_q values as int64 limb tensors [*shape, nl] (valid
    Montgomery values too), made on ``device`` by a generator seeded with
    ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    limbs = torch.randint(0, 1 << 32, tuple(shape) + (ring.nl,), generator=gen, device=device, dtype=torch.int64)
    top = ring.q >> (32 * (ring.nl - 1))  # below q: the top limb below q's
    limbs[..., -1] %= top
    return limbs


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


def time_in_turns(fns: dict, reps, flush):
    """Median device times of several functions of the same work
    (``turn_samples``). Returns {key: ms}."""
    return {k: statistics.median(v) for k, v in turn_samples(fns, reps, flush).items()}


def turn_samples(fns: dict, reps, flush):
    """Device times of several functions of the same work, each run ``reps``
    times in turns (the order reversed every other round: a, b, b, a, ...),
    the L2 flushed before each run. ``flush`` None: not flushed (warm L2),
    the card kept busy instead (``torch.cuda._sleep``) while the host
    enqueues the run, so that the time is the device's and not the host's
    dispatch. Returns {key: [ms, ...]}."""
    import torch

    ts = {k: [] for k in fns}
    keys = list(fns)
    for r in range(reps):
        for k in keys if r % 2 == 0 else keys[::-1]:
            if flush is not None:
                flush.zero_()
            else:
                torch.cuda._sleep(WARM_SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[k]()
            end.record()
            end.synchronize()
            ts[k].append(start.elapsed_time(end))
    return ts


def host_us_in_turns(fns: dict, rounds=10, calls=20):
    """Median host time of one call of each function, in microseconds: the
    host clock over ``calls`` calls in a row (the device not waited for),
    the functions in turns for ``rounds`` rounds. Returns {key: us}."""
    import torch

    ts = {k: [] for k in fns}
    keys = list(fns)
    for r in range(rounds):
        for k in keys if r % 2 == 0 else keys[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[k]()
            ts[k].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in ts.items()}


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


def check_crt(name, ring, n, device, flush, wit_len=WIT_LEN):
    """Phase 2's CRT for one ring: the tensor-core kernel against both plain
    versions and the SIMT kernel, each shape, all timed in this call.
    Returns {(kernel, shape): numbers}."""
    import torch

    from latticefold_torch.rings import ops

    results = {}
    d, nl = ring.d, ring.nl
    K, cols = 4 * d * nl, 8 * nl * d
    # icrt of the input witness, crt of each digit witness, icrt of the folded witness
    for which, N, seed in (("icrt", wit_len, 1), ("crt", n, 2), ("icrt", n, 5)):
        x = rand_field(ring, (N, d), seed, device)
        mat = ops._device_mat(ring, which, device)
        got = ops._transform_tc(ring, which, x)
        err = max_abs_err(f"crt_tc [{name}] ({which}, N={N}) against mat_apply", got,
                          ops.mat_apply(ring.fq, mat, x))
        err += max_abs_err(f"crt_tc [{name}] ({which}, N={N}) against crt_conv_plain", got,
                           ops.crt_conv_plain(ring, which, x))
        max_abs_err(f"crt_kernel (SIMT) [{name}] ({which}, N={N})", ops._transform_simt(ring, which, x), got)
        shape = f"{which} N={N}"
        simt_ms = time_ms(lambda: ops._transform_simt(ring, which, x), 20, flush)
        tc = dict(max_abs_err=err, ms=time_ms(lambda: ops._transform_tc(ring, which, x), 20, flush),
                  simt_ms=simt_ms, plain_ms=time_ms(lambda: ops.mat_apply(ring.fq, mat, x), 3, flush),
                  conv_plain_ms=time_ms(lambda: ops.crt_conv_plain(ring, which, x), 3, flush),
                  library_ms=None,
                  # bytes at 4 B a limb; the byte products the function needs
                  # (C's zeros not counted), two operations each
                  **roofline(2 * N * d * nl * 4, 2 * N * d * d * (4 * nl) ** 2))
        tc["lane_floor"] = roofline(2 * N * d * nl * 8, 2 * N * d * d * (4 * nl) ** 2)
        # a yardstick of the dot half, not the same function: torch._int_mm
        # of signed operands at the dot's M x K x columns
        a8 = torch.randint(-128, 128, (N, K), dtype=torch.int8, device=device)
        b8 = torch.randint(-128, 128, (K, cols), dtype=torch.int8, device=device)
        mm = int_mm_ms([(a8, b8)], flush)
        tc["int_mm_ms"], tc["int_mm_b_col_major_ms"] = mm["b_row_major_ms"], mm["b_col_major_ms"]
        del a8, b8
        results[("crt_tc", shape)] = tc
        b = bound(ring, 2 * N * d, N * d * d)
        results[("crt", shape)] = dict(ms=simt_ms, plain_ms=tc["plain_ms"], max_abs_err=0, **b)
        log(f"[kernels] crt_tc[{name}] {shape}: {tc['ms']:.4f} ms (SIMT crt_kernel {simt_ms:.4f} ms)  "
            f"bound {tc['bound_ms']:.5f} ms ({tc['bound_by']}), lane floor {tc['lane_floor']['bound_ms']:.5f}  "
            f"plain {tc['plain_ms']:.2f} ms, conv plain {tc['conv_plain_ms']:.2f} ms  _int_mm of the dot "
            f"{tc['int_mm_ms']:.4f} ms (B column-major {tc['int_mm_b_col_major_ms']:.4f})  exact against both "
            "plain versions")
        del x, got
    return results


def poseidon_shape(ring) -> str:
    from latticefold_torch.transcript.poseidon import get_config

    cfg = get_config(ring.q)
    return f"t={cfg.rate + cfg.capacity} nl={ring.nl} chunk={cfg.rate - POSEIDON_IDX}"


def sponge_schedule(ring, vals):
    """A mixed schedule on a device sponge (on ``vals``' device) exported
    from a host transcript after a tag: absorbs that fill the rate (resting
    at index == rate), a squeeze (a switch of mode), an absorb of 45 values
    (a switch back, crossing the rate twice), a challenge and its
    re-absorb, a short challenge, a squeeze across a permutation. Returns
    every output and the final (state, index, absorbing), on the CPU."""
    from latticefold_torch.transcript import Transcript
    from latticefold_torch.transcript import device as dtr

    host = Transcript(ring)
    host.absorb_tag(b"poseidon")
    sp = dtr.TraceSponge(ring, *dtr.export_state(ring, host, vals.device))
    fill = sp.rate - sp.index
    sp.absorb(vals[:fill])
    if sp.index != sp.rate:
        raise AssertionError("the schedule does not rest at index == rate")
    outs = [sp.squeeze(3)]
    sp.absorb(vals[fill : fill + 45])
    c = sp.get_challenge()
    sp.absorb_field_element(c)
    outs += [c, dtr.short_challenge_trace(sp), sp.squeeze(41)]
    return [o.cpu() for o in outs], (sp.state.cpu(), sp.index, sp.absorbing)


def max_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def poseidon_chains_ms(nl: int, t: int, rf: int, rp: int, clock_mhz: float) -> dict:
    """Latency bounds of one permutation from its dependent 32-bit
    multiply-adds at 4 cycles each and the card's maximum SM clock, a
    Montgomery product counted as 2 nl^2 of them and a level of additions of
    lazy sums as 2 nl:

    - ``chain_ms``, the permutation's own critical path: per round the
      s-box's three dependent products and one product of the linear
      layer; a full round then adds its t products in a tree of
      ceil(log2 t) levels and reduces the sum (a product), a partial round
      in the factored form adds one value (the rest of its dot is formed
      while the s-box runs: csrc/poseidon.cuh);
    - ``first_chain_ms``, the figure the first design was held to: per round
      6 products and t dependent accumulations of 2 nl along one lane."""
    levels = (t - 1).bit_length()
    prod = 2 * nl * nl
    per_cycle_ms = 4 / (clock_mhz * 1e3)
    new = rf * (5 * prod + levels * 2 * nl) + rp * (4 * prod + 2 * nl)
    first = (rf + rp) * (6 * prod + t * 2 * nl)
    return dict(chain_ms=new * per_cycle_ms, first_chain_ms=first * per_cycle_ms)


def poseidon_bound(ring, n_in: int) -> dict:
    """``bound`` of one permutation of a state [t] read and written, after
    adding ``n_in`` values read, the least over its two equal forms: the
    plain rounds (constants ARK [rf + rp, t] and MDS [t, t]; per round the
    s-boxes at 4 products each, t^2 MDS products and t reductions counted as
    3 products each) and the factored form (csrc/poseidon.cuh: its
    rf t + 2 t^2 + 2 t rp + rp^2 constants; a full round as above, a partial
    round 4 + 2 (t - 1) + 1 products and a reduction). The plain form is the
    least at nl 1 and 2, the factored form at nl 8."""
    from latticefold_torch.transcript.poseidon import get_config

    cfg = get_config(ring.q)
    t, rf, rp = cfg.rate + cfg.capacity, cfg.full_rounds, cfg.partial_rounds
    forms = {
        "plain": bound(ring, t + n_in + (rf + rp) * t + t * t + t, 4 * (rf * t + rp) + (rf + rp) * (t * t + 3 * t)),
        "factored": bound(ring, t + n_in + rf * t + 2 * t * t + 2 * t * rp + rp * rp + t,
                          rf * (4 * t + t * t + 3 * t) + rp * (4 + 2 * (t - 1) + 1 + 3)),
    }
    form = min(forms, key=lambda f: forms[f]["bound_ms"])
    return dict(forms[form], bound_form=form)


def check_poseidon(name, ring, dp, device, flush):
    """Phase 2 for the Poseidon kernels (``csrc/poseidon_kernel.cu``) at one
    ring. The sponge kernel (``transcript.device.sponge_call``, the path's:
    one launch per absorb or squeeze call) against its plain version
    (``sponge_call_plain``: the call's segments with ``permute_plain``
    between them) on the same card inputs: one permutation (a squeeze of
    one value at a mode switch), a chunk at rate index POSEIDON_IDX (an
    absorb of rate - POSEIDON_IDX + 1 values: the chunk, a permutation, one
    trailing value), a multi-permutation absorb at a switch with a trailing
    chunk, and a multi-permutation squeeze; the first design
    (``_permute_kernel``, one permutation a launch, off every path) against
    ``permute_plain`` with and without the chunk; the mixed
    ``sponge_schedule`` on the card against the same on the CPU (the plain
    version). Timed: the chunk call against the first design's chunked
    permutation, in turns, with the L2 flushed before each run (cold) and
    without (warm, the card asleep while the host enqueues: ``time_in_turns``);
    absorb calls of the provers' round-message lengths
    ((degree + 1) d for PROVER_ABSORB_DEGREES and, where DeviceNIFS folds
    the ring, the folding sumcheck's 2b), warm,
    per permutation; the plain version; a launch of a one-element fill (the
    launch floor of this call). Bound of the chunk call and of the first
    design's chunked permutation: ``poseidon_bound`` (bytes at 4 B a limb,
    32-bit multiply-adds at 2 nl^2 a Montgomery product, the least over the
    permutation's two forms); beside it the latency bound, the larger of the
    launch floor and ``poseidon_chains_ms``'s chain, and the first design's
    chain figure. Returns {(kernel, shape): record}."""
    import torch

    from latticefold_torch.transcript import device as dtr
    from latticefold_torch.transcript.poseidon import get_config

    cfg = get_config(ring.q)
    t, rate, rf, rp, nl = cfg.rate + cfg.capacity, cfg.rate, cfg.full_rounds, cfg.partial_rounds, ring.nl
    k = rate - POSEIDON_IDX
    state = rand_field(ring, (t,), 60, device)
    chunk = rand_field(ring, (k + 1,), 61, device)
    n_abs, n_sq = 3 * rate + 7, 2 * rate + 5
    vals = rand_field(ring, (n_abs,), 63, device)

    def new_chunk():
        return dtr.sponge_call(ring, state, chunk, k + 1, POSEIDON_IDX, False)[0]

    def first_chunk():
        return dtr._permute_kernel(ring, state, chunk[:k], POSEIDON_IDX)

    # (label, sponge_call's arguments after the state)
    calls = [("one permutation (a squeeze of 1 at a switch)", (None, 1, 0, True)),
             (f"chunk at rate index {POSEIDON_IDX}", (chunk, k + 1, POSEIDON_IDX, False)),
             (f"absorb of {n_abs} at a switch", (vals, n_abs, 0, True)),
             (f"squeeze of {n_sq} from rate index 3", (None, n_sq, 3, False))]
    err = 0
    for label, args in calls:
        got = dtr.sponge_call(ring, state, *args)
        want = dtr.sponge_call_plain(ring, state, *args)
        err += max_abs_err(f"poseidon [{name}] {label}: state", got[0], want[0])
        if got[1] is not None:
            err += max_abs_err(f"poseidon [{name}] {label}: squeezed", got[1], want[1])
    first_err = max_abs_err(f"poseidon first design [{name}] one permutation",
                            dtr._permute_kernel(ring, state, None, 0), dtr.permute_plain(ring, state))
    first_err += max_abs_err(f"poseidon first design [{name}] chunk at rate index {POSEIDON_IDX}", first_chunk(),
                             dtr.permute_plain(ring, state, chunk[:k], POSEIDON_IDX))
    svals = rand_field(ring, (80,), 62, device)
    card_outs, card_end = sponge_schedule(ring, svals)
    cpu_outs, cpu_end = sponge_schedule(ring, svals.cpu())
    for i, (a, b) in enumerate(zip(card_outs + [card_end[0]], cpu_outs + [cpu_end[0]])):
        err += max_abs_err(f"poseidon [{name}] schedule output {i} (card against the CPU's plain sponge)", a, b)
    if card_end[1:] != cpu_end[1:]:
        raise AssertionError(f"poseidon [{name}]: the schedule's bookkeeping differs between the card and the CPU")

    cold = time_in_turns({"new": new_chunk, "first": first_chunk}, 50, flush)
    warm = time_in_turns({"new": new_chunk, "first": first_chunk}, 50, None)
    per_perm = {}
    fold_degrees = (2 * dp.b,) if dp.B < 1 << 16 else ()  # DeviceNIFS folds B < 2^16 only
    for degree in sorted(set(PROVER_ABSORB_DEGREES + fold_degrees)):
        n = (degree + 1) * ring.d
        perms, _ = dtr.call_plan(n, POSEIDON_IDX, False, rate)
        v = rand_field(ring, (n,), 64, device)
        ms = time_in_turns({"call": lambda: dtr.sponge_call(ring, state, v, n, POSEIDON_IDX, False)}, 50, None)["call"]
        per_perm[f"absorb {n}"] = dict(degree=degree, permutations=perms, call_ms=ms, ms_per_permutation=ms / perms)
    plain_ms = time_ms(lambda: dtr.sponge_call_plain(ring, state, chunk, k + 1, POSEIDON_IDX, False), 3, flush)
    first_plain_ms = time_ms(lambda: dtr.permute_plain(ring, state, chunk[:k], POSEIDON_IDX), 3, flush)
    one = torch.zeros(1, dtype=torch.int64, device=device)
    floor_ms = time_ms(lambda: one.zero_(), 50, flush)
    b = poseidon_bound(ring, k + 1)
    clock = max_clock_mhz()
    chains = poseidon_chains_ms(nl, t, rf, rp, clock)
    rec = dict(ms=cold["new"], first_ms=cold["first"], warm_ms=warm["new"], first_warm_ms=warm["first"],
               per_permutation=per_perm, plain_ms=plain_ms, max_abs_err=err, library_ms=None,
               launch_floor_ms=floor_ms, latency_bound_ms=max(floor_ms, chains["chain_ms"]),
               max_sm_clock_mhz=clock, **chains, **b)
    first_b = poseidon_bound(ring, k)
    first_rec = dict(ms=cold["first"], warm_ms=warm["first"], new_ms=cold["new"], plain_ms=first_plain_ms,
                     max_abs_err=first_err, library_ms=None, launch_floor_ms=floor_ms,
                     chain_ms=chains["first_chain_ms"], latency_bound_ms=max(floor_ms, chains["first_chain_ms"]),
                     max_sm_clock_mhz=clock, **first_b)
    pp = ", ".join(f"{key} ({r['permutations']} perms) {r['ms_per_permutation']:.5f}" for key, r in per_perm.items())
    log(f"[kernels] poseidon[{name}] {poseidon_shape(ring)}: sponge kernel {cold['new']:.5f} ms a one-permutation "
        f"call cold (first design {cold['first']:.5f} in turns), warm {warm['new']:.5f} (first design "
        f"{warm['first']:.5f}); ms a permutation inside the provers' absorbs, warm: {pp}; bound "
        f"{b['bound_ms']:.6f} ms ({b['bound_by']}), latency bound {rec['latency_bound_ms']:.5f} ms (launch floor "
        f"{floor_ms:.5f}, chain {chains['chain_ms']:.5f}; the first design's chain figure "
        f"{chains['first_chain_ms']:.5f}); plain {plain_ms:.2f} ms; exact against the plain version on one "
        "permutation, a chunk, a multi-permutation absorb and squeeze, and the card's schedule against the CPU's")
    shape = poseidon_shape(ring)
    return {("poseidon", shape): rec, ("poseidon_perm", shape): first_rec}


def check_kernels(name, dp, scheme, device, wit_len=WIT_LEN):
    """Phase 2 for one ring: each kernel against its plain version at the
    path's shapes. Returns {(kernel, shape): numbers}."""
    import torch

    ring = scheme.ring
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)  # > 50 MB L2
    n = scheme.n
    results = check_crt(name, ring, n, device, flush, wit_len)

    for Nb, seed in ((dp.K - 1, 3), (1, 4)):
        shape = f"kappa={scheme.kappa} n={n} Nb={Nb}"
        results[("commit_sm90", shape)], results[("commit", shape)] = check_commit(name, scheme, Nb, seed, device,
                                                                                   flush)
    results.update(check_poseidon(name, ring, dp, device, flush))
    del flush
    torch.cuda.empty_cache()
    return results


def commit_turns(label, scheme, f, fcm, flush):
    """The Hopper commit kernel (``mxu._commit_sm90``) on a batch given both
    ways (f n-major, fcm component-major in ``plane_commit.empty_batch``
    storage): equal limb for limb to the first commit kernel
    (``mxu._commit_kernel``) and to the byte-plane route
    (``commit_batch_fused``); the three timed in turns with the L2 flushed,
    and the new kernel's two passes timed apart on its own partials. Bound:
    the function's bytes at 4 B a word (or its 32-bit multiply-adds); lane
    floor: the same at 8 B a word, the int64 lanes the kernels read.
    Returns the record (``ms`` the new kernel's)."""
    import torch

    from latticefold_torch.rings import mxu

    ring, kappa, n = scheme.ring, scheme.kappa, scheme.n
    Nb = f.shape[1]
    got, partial = mxu._commit_sm90(ring, scheme.matrix, f)
    old = mxu._commit_kernel(ring, scheme.matrix, f)
    torch.cuda.synchronize()
    err = int((got != old).sum().item())
    if err:
        raise AssertionError(f"commit_sm90 [{label}] (Nb={Nb}): {err} limbs differ from the first commit kernel's")
    err = int((got != scheme.commit_batch_fused(fcm)).sum().item())
    if err:
        raise AssertionError(f"commit_sm90 [{label}] (Nb={Nb}): {err} limbs differ from the byte-plane route's")
    t = time_in_turns({"new": lambda: mxu._commit_sm90(ring, scheme.matrix, f, partial=partial),
                       "old": lambda: mxu._commit_kernel(ring, scheme.matrix, f),
                       "route": lambda: scheme.commit_batch_fused(fcm)}, 10, flush)
    p1 = time_ms(lambda: mxu._commit_sm90(ring, scheme.matrix, f, mode=1, partial=partial), 10, flush)
    p2 = time_ms(lambda: mxu._commit_sm90(ring, scheme.matrix, f, mode=2, partial=partial), 10, flush)
    n_values = (kappa * n + n * Nb + kappa * Nb) * ring.ncomp * ring.e
    n_products = kappa * Nb * ring.ncomp * n * ring.e**2
    b = bound(ring, n_values, n_products)
    lane = bound(ring, 2 * n_values, n_products)
    plan = mxu.commit_sm90_plan(ring, kappa, n, Nb, mxu._sms(f.device))
    rec = dict(ms=t["new"], old_ms=t["old"], route_ms=t["route"], pass1_ms=p1, pass2_ms=p2,
               lane_floor_ms=lane["bound_ms"], plan=plan._asdict(), max_abs_err=0, **b)
    log(f"[kernels] commit_sm90[{label}] kappa={kappa} n={n} Nb={Nb}: {t['new']:.4f} ms (passes {p1:.4f} + "
        f"{p2:.4f} alone), first commit kernel {t['old']:.4f} ms, byte-plane route {t['route']:.4f} ms (in turns); "
        f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}), lane floor {lane['bound_ms']:.5f} ms; plan {tuple(plan)}; "
        f"equal to both")
    return rec


def check_commit(name, scheme, Nb, seed, device, flush):
    """The Hopper commit kernel against the plain commit on a seeded batch of
    Nb witnesses at the scheme's (kappa, n), then ``commit_turns`` (the
    first commit kernel and the byte-plane route, in turns). Returns
    (the new kernel's record, the first kernel's)."""
    import torch

    from latticefold_torch.rings import mxu
    from latticefold_torch.rings import plane_commit as pc

    ring = scheme.ring
    f = rand_field(ring, (scheme.n, Nb, ring.ncomp, ring.e), seed, device)
    got = mxu.ajtai_commit(ring, scheme.matrix, f)
    want = []  # the plain version's output, from its one timed call
    plain_ms = time_ms(lambda: want.append(commit_plain(ring, scheme.matrix, f)), 1, flush)
    err = int((got != want[0]).sum().item())
    if err:
        raise AssertionError(f"commit_sm90 [{name}] (Nb={Nb}): {err} limbs differ from the plain version")
    del want, got
    fcm = pc.empty_batch(ring, scheme.n, Nb, device)
    fcm.copy_(f.permute(2, 0, 3, 1, 4))
    rec = commit_turns(name, scheme, f, fcm, flush)
    rec["plain_ms"] = plain_ms
    old = {k: v for k, v in rec.items() if k in ("bound_ms", "bound_by", "bytes_ms", "ops_ms", "mad32", "plain_ms",
                                               "max_abs_err", "lane_floor_ms")}
    old.update(ms=rec["old_ms"], new_ms=rec["ms"])
    del f, fcm
    return rec, old


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


@contextlib.contextmanager
def host_permutations(sponge_cls, ring):
    """Counts the permutations of the host sponges of ``sponge_cls`` while the
    block runs: each sponge's absorb and squeeze_native calls replayed on a
    ``transcript.device.GhostSponge`` of ``ring``, started from the sponge's
    rate index and mode when the block first sees it. Yields a function
    giving the count so far."""
    from latticefold_torch.transcript import device as dtr

    saved = {k: getattr(sponge_cls, k) for k in ("absorb", "squeeze_native")}
    seen = {}  # id -> (sponge, ghost): the sponge is kept, so no id is reused

    def counter(sp):
        if id(sp) not in seen:
            _, index, absorbing = sp.snapshot() if hasattr(sp, "snapshot") else (None, sp.index, sp.mode_absorbing)
            seen[id(sp)] = (sp, dtr.GhostSponge(ring, index, absorbing))
        return seen[id(sp)][1]

    def absorb(self, elements):
        counter(self).absorb(len(elements))
        return saved["absorb"](self, elements)

    def squeeze_native(self, n):
        counter(self).squeeze(n)
        return saved["squeeze_native"](self, n)

    sponge_cls.absorb, sponge_cls.squeeze_native = absorb, squeeze_native
    try:
        yield lambda: sum(g.perms for _, g in seen.values())
    finally:
        for k, fn in saved.items():
            setattr(sponge_cls, k, fn)


@contextlib.contextmanager
def sync_debug(mode):
    """torch.cuda's sync debug mode ("warn", "error") while the block runs."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def no_sync(fn):
    """``fn`` run with the sync debug mode at "error": a host synchronization
    inside it (an ``.item()``, a read of the device, a synchronous copy from
    the host) raises."""
    def run(*args, **kw):
        with sync_debug("error"):
            return fn(*args, **kw)
    return run


@contextlib.contextmanager
def count_syncs(acc: dict):
    """Counts in ``acc["n"]`` the host synchronizations that torch reports
    (sync debug mode "warn": one warning each) while the block runs."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with sync_debug("warn"):
            yield acc
    acc["n"] = sum(1 for w in caught if "synchroniz" in str(w.message))


def state_of(transcript):
    """A transcript's sponge state as (ints, index, absorbing)."""
    ints, index, absorbing = transcript.snapshot_state()
    return [int(v) for v in ints], index, absorbing


def witness_digest(ring, w) -> str:
    """SHA-256 of a witness's f, f_coeff, f_hat and w_ccs limbs."""
    import hashlib

    h = hashlib.sha256()
    for k in ("f", "f_coeff", "f_hat", "w_ccs"):
        h.update(getattr(w, k).cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def device_sponge_calls():
    """While the block runs, every ``TraceSponge.absorb`` / ``squeeze`` call is
    replayed on a ``transcript.device.GhostSponge`` (started from the
    sponge's bookkeeping when first seen). Yields a function giving the
    schedule's (launches, permutations): the sponge kernel launches once per
    absorb call and once per squeeze call that permutes."""
    from latticefold_torch.transcript import device as dtr

    cls = dtr.TraceSponge
    saved = {k: getattr(cls, k) for k in ("absorb", "squeeze")}
    seen = {}  # id -> (sponge, ghost): the sponge is kept, so no id is reused

    def ghost(sp):
        if id(sp) not in seen:
            seen[id(sp)] = (sp, dtr.GhostSponge(sp.ring, sp.index, sp.absorbing))
        return seen[id(sp)][1]

    def absorb(self, vals):
        ghost(self).absorb(int(vals.shape[0]))
        return saved["absorb"](self, vals)

    def squeeze(self, n):
        ghost(self).squeeze(n)
        return saved["squeeze"](self, n)

    cls.absorb, cls.squeeze = absorb, squeeze
    try:
        yield lambda: (sum(g.launches for _, g in seen.values()), sum(g.perms for _, g in seen.values()))
    finally:
        for k, fn in saved.items():
            setattr(cls, k, fn)


def check_permutations(what, perms: int, want=None):
    """The Poseidon sponge kernel's permutations (``cuda.PERMUTATIONS``)
    against the schedule's count ``perms`` and, where given, ``want``: the
    permutations the host transcript made for the same work."""
    from latticefold_torch import cuda

    got = cuda.PERMUTATIONS["poseidon"]
    if got != perms or want is not None and got != want:
        raise AssertionError(f"{what}: the Poseidon kernel ran {got} permutations, its schedule {perms}, the host "
                             f"transcript {want}")


def device_nifs_launches(dp, n, calls) -> dict:
    """The launches of one ``DeviceNIFS.prove`` at Ajtai width ``n`` whose
    device transcript makes ``calls`` absorb calls and squeeze calls that
    permute: per decomposition K digit CRTs, the statement split's ICRT and
    K CRTs and the batch commit (a Hopper dot per 2^15-term slice, one
    diagonal epilogue); the rho CRT and the folded witness's ICRT; the
    Poseidon sponge kernel once per such call."""
    from latticefold_torch.rings import plane_commit

    slices = -(-n // plane_commit._K_SLICE)
    return {"crt_tc": 4 * dp.K + 4, "plane_dot_sm90": 2 * slices, "plane_epilogue_diag": 2, "poseidon": calls}


def run_device_nifs(label, ring, ccs, dp, scheme, acc, w_acc, cm_i, wit, want: dict):
    """One ``DeviceNIFS.prove`` (its device part ``_trace`` under sync debug
    "error", the whole prove counted under "warn"), its launches counted:
    ``device_nifs_launches`` with the device sponge's calls
    (``device_sponge_calls``), and the Poseidon kernel's permutations equal
    to the schedule's and to ``want["perms"]`` (the modular prove's host
    permutations). Its proof bytes, folded accumulator bytes, witness
    digest and transcript state must equal ``want``'s (the modular prove's).
    Returns the record."""
    import torch

    from latticefold_torch import cuda, serialization as ser
    from latticefold_torch.nifs.device_step import DeviceNIFS
    from latticefold_torch.transcript import Transcript

    dn = DeviceNIFS(ccs, dp, scheme)
    dn._trace = no_sync(dn._trace)
    t, syncs = Transcript(ring), {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    t0 = time.perf_counter()
    with count_syncs(syncs), device_sponge_calls() as schedule:
        folded, w0, proof = dn.prove(acc, w_acc, cm_i, wit, t)
        torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    calls, perms = schedule()
    expected = device_nifs_launches(dp, scheme.n, calls)
    if launches != expected:
        raise AssertionError(f"DeviceNIFS [{label}]: launches {launches}, expected {expected}")
    check_permutations(f"DeviceNIFS [{label}]", perms, want["perms"])
    got = dict(proof=ser.serialize_proof(ring, proof), acc=ser.serialize_lcccs(ring, folded),
               witness=witness_digest(ring, w0), state=state_of(t))
    for k, v in got.items():
        if v != want[k]:
            raise AssertionError(f"DeviceNIFS [{label}]: the {k} differs from the modular prover's")
    rec = dict(prove_s=prove_s, syncs=syncs["n"], launches=launches, permutations=perms,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"[device nifs {label}] prove {prove_s:.3f} s, {syncs['n']} host syncs in the prove (none in its device "
        f"part: sync debug mode error), launches {launches}, {perms} Poseidon permutations; proof, folded "
        "accumulator, witness and transcript state equal the modular prover's")
    return rec


def small_fold(name, device, steps=1):
    """The tests' small fixture (kappa = 4, seed 7) for ``name`` folded
    ``steps`` times on ``device`` at the fold phase's preset (each step
    folds the fresh instance into the accumulator of the one before, on a
    fresh transcript); returns each step's proof bytes and the last folded
    accumulator's bytes (``serialization.serialize_proof`` /
    ``serialize_lcccs``)."""
    import latticefold_torch.nifs as nifs
    import latticefold_torch.nifs.linearization as linearization
    from latticefold_torch import params, serialization
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
    w_acc, proofs = wit, []
    for _ in range(steps):
        acc, w_acc, proof = nifs.prove(acc, w_acc, cm_i, wit, Transcript(ring), ccs, scheme, dp)
        proofs.append(serialization.serialize_proof(ring, proof))
    return proofs, serialization.serialize_lcccs(ring, acc)


def small_fold_timed(name, device, steps):
    """``small_fold`` and the seconds it took."""
    t0 = time.perf_counter()
    out = small_fold(name, device, steps)
    return out, time.perf_counter() - t0


def cpu_worker_init():
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)


def start_cpu_halves(pool) -> dict:
    """Starts, in ``pool``, the CPU halves of the card-against-CPU checks:
    each ring's small fixture (``small_fold_timed``, in PATHS order) and
    phase 4c's prove (``plus_small_prove``, under "plus small"). Returns
    their AsyncResults by ring name."""
    import torch

    cpu = torch.device("cpu")
    jobs = {name: pool.apply_async(small_fold_timed, (name, cpu, SMALL_CHAIN_STEPS if name == CHAIN[0] else 1))
            for name in PATHS}
    jobs["plus small"] = pool.apply_async(plus_small_prove, (cpu,))
    return jobs


@contextlib.contextmanager
def bigm_calls():
    """Counts the calls of ``sumcheck.prove_host_bigm`` (the big-m path's
    sumcheck; the standard path never calls it) while the block runs."""
    from latticefold_torch import sumcheck

    orig = sumcheck.prove_host_bigm
    calls = [0]

    def spy(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    sumcheck.prove_host_bigm = spy
    try:
        yield calls
    finally:
        sumcheck.prove_host_bigm = orig


def check_peak(what, peak, device):
    """Raise unless ``peak`` is under PEAK_SHARE_MAX of the card's memory;
    returns the card's memory."""
    import torch

    total = torch.cuda.get_device_properties(device).total_memory
    if peak >= PEAK_SHARE_MAX * total:
        raise AssertionError(f"{what}: peak device memory {peak} B is not under {PEAK_SHARE_MAX} of the "
                             f"card's {total} B")
    return total


def prove_launches(dp, n) -> dict:
    """The launches of one ``nifs.prove`` at Ajtai width ``n``: 2K crt + 1
    icrt on the tensor-core CRT, and per decomposition batch commit one
    Hopper dot per 2^15-term slice and one diagonal epilogue; no other
    kernel (the SIMT CRT, the item-per-thread epilogue and the commit
    kernel are baselines and cross-checks only)."""
    from latticefold_torch.rings import plane_commit

    slices = -(-n // plane_commit._K_SLICE)
    return {"crt_tc": 2 * dp.K + 1, "plane_dot_sm90": 2 * slices, "plane_epilogue_diag": 2}


def run_fold(name, dp, scheme, reps, device, profile=False, label=None, big_m=None,
             expand_nvars=BIGM_EXPAND_NVARS, expect_big_m=False, device_nifs=False):
    """Phase 3 for one ring: the fold at WIT_LEN, X_LEN, as
    benches/sweep_e2e.py sets it up, on the path ``big_m`` asks for (None:
    the port's rule), which must be the big-m path iff ``expect_big_m``;
    with ``device_nifs``, the same fold once more through ``DeviceNIFS``
    (``run_device_nifs``). Returns a dict of results; raises on any failed
    check."""
    import torch

    import latticefold_torch.nifs as nifs
    import latticefold_torch.nifs.linearization as linearization
    from latticefold_torch import cuda, serialization
    from latticefold_torch.arith.ccs import CCCS, CCS, get_test_dummy_r1cs
    from latticefold_torch.arith.witness import Witness
    from latticefold_torch.native import NativeSponge
    from latticefold_torch.arith.ccs import Commitment
    from latticefold_torch.nifs import decomposition
    from latticefold_torch.rings import ops
    from latticefold_torch.transcript import Transcript

    ring = scheme.ring
    label = label or name
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
    log(f"[fold {label}] wit_len={WIT_LEN} m={ccs.m} n={scheme.n} kappa={scheme.kappa} {dp}: setup "
        f"{setup_s:.2f} s ({sponge_cls.__name__})")

    def prove(transcript=None):
        return nifs.prove(acc, wit, cm_i, wit, transcript or Transcript(ring), ccs, scheme, dp, big_m=big_m,
                          expand_nvars=expand_nvars)

    # the main path, counted: every kernel of the path must launch in it,
    # as often as the code says (prove_launches), and no other
    torch.cuda.reset_peak_memory_stats(device)
    live = torch.cuda.memory_allocated(device)
    cuda.reset_launches()
    sponge = {"s": 0.0}
    transcript = Transcript(ring)
    t0 = time.perf_counter()
    with sponge_timer(sponge_cls, sponge), bigm_calls() as calls, \
            host_permutations(sponge_cls, ring) as perms:
        folded, w0, proof = prove(transcript)
        torch.cuda.synchronize()
        perms = perms()
    first_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}  # and no other kernel
    path = "big-m" if calls[0] else "standard"
    log(f"[fold {label}] first prove {first_s:.3f} s on the {path} path (host sponge {sponge['s']:.3f} s); "
        f"launches {launches}")
    expected = prove_launches(dp, scheme.n)
    if launches != expected:
        raise AssertionError(f"[{label}] launches per prove {launches}, expected {expected}")
    if bool(calls[0]) != expect_big_m:
        raise AssertionError(f"[{label}] the prove took the {path} path")

    t0 = time.perf_counter()
    folded_v = nifs.verify(acc, cm_i, proof, Transcript(ring), ccs, dp)
    verify_s = time.perf_counter() - t0
    if (folded_v.r, folded_v.v, folded_v.u, folded_v.cm) != (folded.r, folded.v, folded.u, folded.cm):
        raise AssertionError("verifier's folded accumulator differs from the prover's")
    if w0.commit(scheme) != folded.cm:
        raise AssertionError(f"[{label}] the folded witness does not open the folded commitment")
    log(f"[fold {label}] verify {verify_s:.3f} s: verifier accepts; w0 opens the folded commitment")

    prove_s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, _, again = prove()
        torch.cuda.synchronize()
        prove_s.append(time.perf_counter() - t0)
        if again != proof:
            raise AssertionError("a timed prove gave another proof")
    peak = torch.cuda.max_memory_allocated(device)
    reserved = torch.cuda.max_memory_reserved(device)
    check_peak(f"fold {label}", peak, device)
    log(f"[fold {label}] timed prove s {prove_s}; peak device memory {peak} B ({reserved} B reserved; "
        f"{live} B held at the counted prove's start)")
    dnifs = None
    if device_nifs:
        want = dict(proof=serialization.serialize_proof(ring, proof), acc=serialization.serialize_lcccs(ring, folded),
                    witness=witness_digest(ring, w0), state=state_of(transcript), perms=perms)
        dnifs = run_device_nifs(label, ring, ccs, dp, scheme, acc, wit, cm_i, wit, want)
        dnifs["modular_prove_s"] = first_s

    # one decomposition batch against the commit kernel: the digit witnesses
    # of the prove's right side, committed by commit_batch, must give the
    # commitments the byte-plane route put in the proof
    wit_s = decomposition.decompose_witness(ring, dp, wit, ccs.m)
    batch = torch.stack([w.f for w in wit_s[1:]], dim=1)  # n-major, as commit_batch takes it
    cms = ops.to_host(ring, scheme.commit_batch(batch))
    if [Commitment(ring, list(cms[:, i])) for i in range(dp.K - 1)] != proof.decomposition_proof_r.y_s[1:]:
        raise AssertionError("the fold's batch commitments differ from the commit kernel's")
    del wit_s, batch
    log(f"[fold {label}] the proof's {dp.K - 1} batch commitments equal the commit kernel's")
    out = dict(preset=str(dp), m=ccs.m, n=scheme.n, kappa=scheme.kappa, path=path, setup_s=setup_s,
               first_prove_s=first_s, sponge_s=sponge["s"], prove_s=prove_s, verify_s=verify_s,
               peak_bytes=peak, reserved_bytes=reserved, live_bytes=live, launches=launches,
               permutations=perms, device_nifs=dnifs, proof_bytes=serialization.serialize_proof(ring, proof))
    if profile:
        out["profile"] = profile_prove(name, prove)
    return out


def run_chain_phase(device, fold_proof: bytes):
    """Phase 3b: the IVC chain of ``latticefold_torch.e2e`` (``CHAIN``) on
    the card. Each step's prove is counted on its own (the counts set to 0
    just before it and read just after) and must launch what the fold
    phase's prove launches; step 1's proof bytes must be the fold phase's
    (the same instance and transcript); every proof and accumulator must
    survive serialize -> deserialize -> serialize; the verifier replays the
    steps from the bootstrap accumulator and must reach the prover's
    accumulator after each; the last witness must open the last
    commitment; and step CHAIN_RESUME_AFTER + 1, proved again from the
    checkpoint bytes of the accumulator and witness before it, must give
    the same proof bytes. Returns the record; raises on any failed check."""
    import zlib

    import torch

    from latticefold_torch import e2e, nifs, serialization as ser
    from latticefold_torch.arith.witness import Witness
    from latticefold_torch.transcript import Transcript

    name, kappa, steps = CHAIN
    s = e2e.setup_chain(name, WIT_LEN, X_LEN, kappa, device)
    ring, dp = s.ring, s.dp
    expected = prove_launches(dp, s.scheme.n)
    log(f"[chain {name}] wit_len={WIT_LEN} m={s.ccs.m} n={s.scheme.n} kappa={kappa}: setup {s.setup_s:.2f} s")
    accs, checkpoint, rec = [], {}, []

    def on_step(i, acc, w_acc, step):
        proof = ser.serialize_proof(ring, step.proof)
        acc_bytes = ser.serialize_lcccs(ring, acc)
        if (ser.serialize_proof(ring, ser.deserialize_proof(ring, proof)) != proof
                or ser.serialize_lcccs(ring, ser.deserialize_lcccs(ring, acc_bytes)) != acc_bytes):
            raise AssertionError(f"chain step {i}: the proof or accumulator does not survive a round trip")
        if step.launches != expected:
            raise AssertionError(f"chain step {i}: launches {step.launches}, expected {expected}")
        if i == 1 and proof != fold_proof:
            raise AssertionError("chain step 1: the proof differs from the fold phase's")
        if i == CHAIN_RESUME_AFTER:
            checkpoint.update(acc=acc_bytes, f=ser.serialize_witness_f(ring, w_acc.f_coeff))
        accs.append(acc_bytes)
        done = sum(r["permutations"] for r in rec)
        rec.append(dict(step=i, prove_s=step.prove_s, proof_bytes=len(proof),
                        proof_zlib_bytes=len(zlib.compress(proof)), peak_bytes=step.peak_bytes,
                        live_bytes=step.live_bytes, launches=step.launches, permutations=perms() - done,
                        want=dict(proof=proof, acc=acc_bytes, witness=witness_digest(ring, w_acc),
                                  state=step.transcript_state)))
        log(f"[chain {name}] step {i}: prove {step.prove_s:.3f} s, proof {len(proof)} B "
            f"({rec[-1]['proof_zlib_bytes']} B zlib), peak device memory {step.peak_bytes} B "
            f"({step.live_bytes} B held at its start), launches {step.launches}; round trips hold")

    sponge_cls = type(Transcript(ring).sponge)
    with host_permutations(sponge_cls, ring) as perms:
        res = e2e.fold_steps(s, steps, on_step)

    t0 = time.perf_counter()
    vacc = s.acc0
    for i, st in enumerate(res.steps):
        vacc = nifs.verify(vacc, s.cm_i, st.proof, Transcript(ring), s.ccs, dp)
        if ser.serialize_lcccs(ring, vacc) != accs[i]:
            raise AssertionError(f"chain step {i + 1}: the verifier's accumulator differs from the prover's")
    verify_s = time.perf_counter() - t0
    if res.w_acc.commit(s.scheme) != res.acc.cm:
        raise AssertionError(f"chain: w_{steps} does not open acc_{steps}.cm")
    log(f"[chain {name}] the verifier replays all {steps} steps in {verify_s:.3f} s and reaches the "
        f"prover's accumulator after each; w_{steps} opens acc_{steps}.cm")

    # resume from the checkpoint: the accumulator and the witness's digits
    del res
    acc = ser.deserialize_lcccs(ring, checkpoint["acc"])
    f_coeff = ser.deserialize_witness_f(ring, checkpoint["f"], device)
    w_acc = Witness.from_f_coeff(ring, dp, f_coeff, n_pad=s.ccs.m)
    syncs = {}
    with count_syncs(syncs):
        _, _, again = e2e.prove_step(s, acc, w_acc)
    if again.launches != expected:
        raise AssertionError(f"chain: the resumed step launched {again.launches}, expected {expected}")
    if ser.serialize_proof(ring, again.proof) != rec[CHAIN_RESUME_AFTER]["want"]["proof"]:
        raise AssertionError(f"chain: step {CHAIN_RESUME_AFTER + 1} resumed from the checkpoint "
                             "gives another proof")
    log(f"[chain {name}] step {CHAIN_RESUME_AFTER + 1} resumed from the checkpoint "
        f"({len(checkpoint['acc'])} + {len(checkpoint['f'])} B): the same proof bytes "
        f"(prove {again.prove_s:.3f} s, launches {again.launches}, {syncs['n']} host syncs)")
    del s, acc, w_acc, f_coeff, again
    torch.cuda.empty_cache()
    return dict(ring=name, kappa=kappa, steps=rec, verify_s=verify_s, resumed_syncs=syncs["n"],
                checkpoint_bytes=dict(lcccs=len(checkpoint["acc"]), witness_f=len(checkpoint["f"])))


def run_fused_chain_phase(device, chain: dict):
    """Phase 3e: the chain of phase 3b (``CHAIN``) through ``DeviceNIFS``
    (``e2e.setup_chain(..., fused=True)``), each step by
    ``run_device_nifs``'s checks: its device part raises on any host sync,
    its launches are ``device_nifs_launches`` with its device sponge's calls,
    its Poseidon permutations the modular step's, and its proof bytes (step 1's the fold phase's too),
    folded accumulator, witness and transcript state are those of phase
    3b's step. Pops each step's ``want`` from ``chain``. Returns the
    record."""
    import torch

    from latticefold_torch import e2e, serialization as ser

    name, kappa, steps = CHAIN
    s = e2e.setup_chain(name, WIT_LEN, X_LEN, kappa, device, fused=True)
    s.fused._trace = no_sync(s.fused._trace)
    ring = s.ring
    acc, w_acc, rec = s.acc0, s.wit, []
    for i in range(1, steps + 1):
        want = chain["steps"][i - 1].pop("want")
        want["perms"] = chain["steps"][i - 1]["permutations"]
        syncs = {}
        with count_syncs(syncs), device_sponge_calls() as schedule:
            acc, w_acc, step = e2e.prove_step(s, acc, w_acc)
        calls, perms = schedule()
        expected = device_nifs_launches(s.dp, s.scheme.n, calls)
        if step.launches != expected:
            raise AssertionError(f"fused chain step {i}: launches {step.launches}, expected {expected}")
        check_permutations(f"fused chain step {i}", perms, want["perms"])
        got = dict(proof=ser.serialize_proof(ring, step.proof), acc=ser.serialize_lcccs(ring, acc),
                   witness=witness_digest(ring, w_acc), state=step.transcript_state)
        for k, v in got.items():
            if v != want[k]:
                raise AssertionError(f"fused chain step {i}: the {k} differs from phase 3b's step {i}")
        rec.append(dict(step=i, prove_s=step.prove_s, modular_prove_s=chain["steps"][i - 1]["prove_s"],
                        syncs=syncs["n"], launches=step.launches, permutations=perms, peak_bytes=step.peak_bytes))
        log(f"[fused chain {name}] step {i}: prove {step.prove_s:.3f} s (modular {rec[-1]['modular_prove_s']:.3f} "
            f"s), {syncs['n']} host syncs in the prove (none in its device part), launches {step.launches}, "
            f"{perms} Poseidon permutations, "
            f"peak {step.peak_bytes} B; proof, accumulator, witness and transcript state equal phase 3b's")
    if w_acc.commit(s.scheme) != acc.cm:
        raise AssertionError("fused chain: the last witness does not open the last commitment")
    del s, acc, w_acc
    torch.cuda.empty_cache()
    return dict(ring=name, kappa=kappa, steps=rec)


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


def roofline(n_bytes: int, ops: int, peak_ops: float = PEAK_INT8_OPS_PER_S) -> dict:
    """Least time for work that moves ``n_bytes`` (each input read once,
    each output written once) and does ``ops`` operations (a multiply-add
    is two) at ``peak_ops`` per second: the larger of the two times."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak_ops * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, ops=ops)


def max_abs_err(what, got, want) -> int:
    """0, or raise: ``got`` must equal the plain version's ``want`` exactly."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} against the plain "
                             f"version's {want.dtype}{tuple(want.shape)}")
    err = int((got.double() - want.double()).abs().max().item())
    if err:
        raise AssertionError(f"{what}: differs from the plain version (max |err| {err})")
    return err


def counted(what, fn, expected: dict):
    """Run ``fn`` once with every launch count set to 0 just before it and
    read just after: the kernels of ``expected`` must have launched exactly
    that often, and no other. Returns (fn's result, the counts)."""
    import torch

    from latticefold_torch import cuda

    cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected}")
    return out, launches


def int_mm_ms(pairs, flush):
    """ms of ``torch._int_mm`` over the (a, b) pairs, timed together, with
    each b as given (row-major: N-contiguous) and handed column-major
    (``b.t().contiguous().t()``, made outside the timed region: cuBLASLt's
    own int8 layout), as {"b_row_major_ms", "b_col_major_ms"}; or None
    where it does not take the shape (M > 16, K and N multiples of 8)."""
    import torch

    if not all(a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0 for a, b in pairs):
        return None
    cols = [(a, b.t().contiguous().t()) for a, b in pairs]
    out = {}
    for key, ps in (("b_row_major_ms", pairs), ("b_col_major_ms", cols)):
        for a, b in ps:
            torch._int_mm(a, b)
        out[key] = time_ms(lambda ps=ps: [torch._int_mm(a, b) for a, b in ps], 10, flush)
    del cols
    return out


def plane_commit_shape(label, name, kappa, n, Nb, seed, wseed, device, flush, with_route_plain,
                       with_commit_plain=False):
    """Phase 1b at one commit shape: ``commit_batch_fused`` counted and held
    against ``commit_batch_cm`` (the Hopper commit kernel), kernels A and B
    against their plain versions, the Hopper commit kernel against the first
    (``commit_turns``), every time. Returns (record, kernels JSON entries:
    kernels A and B, and with ``with_commit_plain`` both commit kernels)."""
    import torch

    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.rings import mxu
    from latticefold_torch.rings import plane_commit as pc
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring(name)
    c, e, nl = ring.ncomp, ring.e, ring.nl
    L = e * Nb * nl
    scheme = AjtaiScheme(ring, kappa, n, seed=seed, device=device)
    pre = scheme._fused_planes
    fcm = pc.empty_batch(ring, n, Nb, device)  # rows 16-byte aligned, as the fold's batches are
    fcm.copy_(rand_field(ring, (c, n, e, Nb), wseed, device))
    slices = [(k0, min(n, k0 + pc._K_SLICE)) for k0 in range(0, n, pc._K_SLICE)]
    got, launches = counted(f"commit_batch_fused [{label}]", lambda: scheme.commit_batch_fused(fcm),
                            {"plane_dot_sm90": len(slices), "plane_epilogue_diag": 1})
    if (got != scheme.commit_batch_cm(fcm)).any():
        raise AssertionError(f"commit_batch_fused [{label}] differs from commit_batch_cm (the commit kernel)")
    rec = dict(ring=name, kappa=kappa, n=n, Nb=Nb, launches=launches)
    if with_route_plain:
        planes = mxu.ajtai_precompute(ring, scheme.matrix)
        if (got != mxu.ajtai_commit_cm(ring, planes, fcm)).any():
            raise AssertionError(f"commit_batch_fused [{label}] differs from the plain byte-plane route")
        rec["route_plain_ms"] = time_ms(lambda: mxu.ajtai_commit_cm(ring, planes, fcm), 2, flush)
        del planes
    # the Hopper commit kernel (commit_batch_cm's) against the first commit
    # kernel and the route, in turns; where phase 1b emits its entries, also
    # against the plain commit
    f = fcm.permute(1, 3, 0, 2, 4).contiguous()
    cm = rec["commit_sm90"] = commit_turns(label, scheme, f, fcm, flush)
    if with_commit_plain:
        if (got != commit_plain(ring, scheme.matrix, f)).any():
            raise AssertionError(f"commit_sm90 [{label}] differs from the plain commit")
        cm["plain_ms"] = time_ms(lambda: commit_plain(ring, scheme.matrix, f), 1, flush)
    del f
    rec["fused_ms"] = time_ms(lambda: scheme.commit_batch_fused(fcm), 20, flush)
    rec["cm_ms"] = cm["ms"]
    rec["fused_commits_per_s"] = Nb / (rec["fused_ms"] / 1e3)
    rec["cm_commits_per_s"] = Nb / (rec["cm_ms"] / 1e3)
    rows = pre.rows
    mpad = pre.lhs_i8.shape[1]
    out_bytes = kappa * Nb * c * e * nl * 4
    rec["route_bound"] = roofline(c * rows * n + n * Nb * c * e * nl * 4 + out_bytes,
                                   2 * c * rows * n * 4 * L)
    rec["cm_bound"] = bound(ring, (kappa * n + n * Nb + kappa * Nb) * c * e, kappa * Nb * c * n * e**2)

    # kernel A (the Hopper dot) per slice, and kernel B, each against its
    # plain version; the mma.sync dot timed beside the Hopper dot
    w2d = fcm.reshape(c, n, L)
    P = torch.stack([pc.plane_dot(pre.lhs_i8[:, :, a:b], w2d[:, a:b]) for a, b in slices])
    for si, (a, b) in enumerate(slices):
        max_abs_err(f"plane_dot_sm90 [{label}] slice {si}", P[si],
                    pc.plane_dot_plain(pre.lhs_i8[:, :, a:b], w2d[:, a:b]))
    ks = slices[0][1]
    lhs0, w0 = pre.lhs_i8[:, :, :ks], w2d[:, :ks]
    max_abs_err(f"plane_dot (mma.sync) [{label}]", pc.plane_dot_mma(lhs0, w0), P[0])
    out_a = c * mpad * 4 * L * 4
    kern_a = dict(max_abs_err=0, ms=time_ms(lambda: pc.plane_dot(lhs0, w0), 20, flush),
                  mma_sync_ms=time_ms(lambda: pc.plane_dot_mma(lhs0, w0), 20, flush),
                  plain_ms=time_ms(lambda: pc.plane_dot_plain(lhs0, w0), 2, flush),
                  **roofline(c * mpad * ks + c * ks * L * 4 + out_a, 2 * c * mpad * ks * 4 * L))
    # the least time the port's layout allows: the int64 lanes are 8 B a word
    kern_a["lane_floor"] = roofline(c * mpad * ks + c * ks * L * 8 + out_a, 2 * c * mpad * ks * 4 * L)
    planes_i8 = pc._signed_planes(w0, "full").to(torch.int8)
    mm = int_mm_ms([(lhs0[ci], planes_i8[ci]) for ci in range(c)], flush) or {}
    kern_a["library_ms"], kern_a["library_b_col_major_ms"] = mm.get("b_row_major_ms"), mm.get("b_col_major_ms")
    del planes_i8
    B = pc.epilogue(ring, P, pre.sM, rows, n, Nb)
    if (B != got).any():
        raise AssertionError(f"plane_epilogue_diag [{label}] differs from commit_batch_fused's result")
    max_abs_err(f"plane_epilogue_diag [{label}]", B, pc.epilogue_plain(ring, P, pre.sM, rows, n, Nb))
    max_abs_err(f"plane_epilogue (items) [{label}]", pc.epilogue_items(ring, P, pre.sM, rows, n, Nb), B)
    # the diagonal kernel and the item-per-thread kernel in turns
    turns = time_in_turns({"diag": lambda: pc.epilogue(ring, P, pre.sM, rows, n, Nb),
                           "items": lambda: pc.epilogue_items(ring, P, pre.sM, rows, n, Nb)}, 20, flush)
    items = c * kappa * Nb * e * e
    kern_b = dict(max_abs_err=0, ms=turns["diag"], items_ms=turns["items"],
                  plain_ms=time_ms(lambda: pc.epilogue_plain(ring, P, pre.sM, rows, n, Nb), 2, flush),
                  library_ms=None,
                  # bytes: the rows it reads of P, sM, the output; operations: the
                  # 32-bit multiply-adds of the wide REDCs and the fold's products
                  **roofline(len(slices) * c * (rows + 1) * 4 * L * 4 + c * len(slices) * mpad * 4 + out_bytes,
                             items * (nl + 1) * nl + c * kappa * Nb * e * (e - 1) * 2 * nl * nl,
                             PEAK_MAD32_PER_S))
    kern_items = dict(kern_b, ms=turns["items"])
    del kern_items["items_ms"]
    rec.update(plane_dot_sm90=kern_a, plane_epilogue_diag=kern_b, plane_epilogue=kern_items)
    log(f"[plane commit {label}] {name} kappa={kappa} n={n} Nb={Nb}: fused {rec['fused_ms']:.4f} ms "
        f"({rec['fused_commits_per_s']:.1f} commits/s, bound {rec['route_bound']['bound_ms']:.4f} ms "
        f"{rec['route_bound']['bound_by']}), commit kernel {rec['cm_ms']:.4f} ms "
        f"({rec['cm_commits_per_s']:.1f} commits/s, bound {rec['cm_bound']['bound_ms']:.4f} ms); "
        f"A {kern_a['ms']:.4f} ms (mma.sync {kern_a['mma_sync_ms']:.4f}; bound "
        f"{kern_a['bound_ms']:.4f} {kern_a['bound_by']}, lane floor {kern_a['lane_floor']['bound_ms']:.4f}, plain "
        f"{kern_a['plain_ms']:.2f}, _int_mm {kern_a['library_ms']} / B column-major "
        f"{kern_a['library_b_col_major_ms']}), B {kern_b['ms']:.4f} ms (items "
        f"{kern_b['items_ms']:.4f}; bound {kern_b['bound_ms']:.4f}, plain {kern_b['plain_ms']:.2f}); "
        f"launches {launches}; "
        f"equal to the commit kernel{' and the plain route' if with_route_plain else ''}")
    entries = route_entries(label, rec, launches)
    if with_commit_plain:
        entries += commit_entries(label, rec, launches)
    return rec, entries


ROUTE_KERNELS = ("plane_dot_sm90", "plane_epilogue_diag", "plane_epilogue")  # the last off the path


def route_entries(label, rec, launches):
    """The ``kernels`` JSON entries of kernels A (the Hopper dot) and B (the
    diagonal kernel, and the item-per-thread kernel off the main path) from
    a phase 1b record, with ``launches`` from the counted run of its path."""
    entries = []
    for key in ROUTE_KERNELS:
        r = rec[key]
        extra = {k: v for k, v in r.items() if k in ("mma_sync_ms", "items_ms", "library_b_col_major_ms")}
        if "lane_floor" in r:
            extra["lane_floor_ms"] = r["lane_floor"]["bound_ms"]
        entries.append(dict(
            KERNEL_INFO[key], name=f"{KERNEL_INFO[key]['name']}[{label}]", launches=launches.get(key, 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], on_main_path=key != "plane_epilogue",
            shape=f"{rec['ring']} kappa={rec['kappa']} n={rec['n']} Nb={rec['Nb']}", **extra))
    return entries


def commit_entries(label, rec, launches):
    """The ``kernels`` JSON entries of the Hopper commit kernel and the first
    one at a phase 1b shape (neither on the path that phase counts: the
    route's), from its record."""
    cm = rec["commit_sm90"]
    shape = f"{rec['ring']} kappa={rec['kappa']} n={rec['n']} Nb={rec['Nb']}"
    common = dict(max_abs_err=0, plain_ms=cm["plain_ms"], bound_ms=cm["bound_ms"], bound_by=cm["bound_by"],
                  library_ms=None, lane_floor_ms=cm["lane_floor_ms"], on_main_path=False, shape=shape)
    return [
        dict(KERNEL_INFO["commit_sm90"], **common, name=f"{KERNEL_INFO['commit_sm90']['name']}[{label}]",
             launches=launches.get("commit_sm90", 0), ms=cm["ms"], old_ms=cm["old_ms"], route_ms=cm["route_ms"],
             pass1_ms=cm["pass1_ms"], pass2_ms=cm["pass2_ms"]),
        dict(KERNEL_INFO["commit"], **common, name=f"{KERNEL_INFO['commit']['name']}[{label}]",
             launches=launches.get("commit", 0), ms=cm["old_ms"], new_ms=cm["ms"]),
    ]


def check_plane_commit(device):
    """Phase 1b, the batch commit: bench.py's shape, then each ring's fold
    commit shape."""
    import torch

    from latticefold_torch import params

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    record, entries = {}, []
    name, kappa, n, seed, batches = BENCH_COMMIT
    for Nb in batches:
        rec, ent = plane_commit_shape(f"bench b{Nb}", name, kappa, n, Nb, seed, 100 + Nb, device, flush, True, True)
        record[f"bench b{Nb}"] = rec
        entries += ent
        torch.cuda.empty_cache()
    # two slices: bench.py's kappa and Nb 16 at n 2^16 (two kernel A
    # launches, one kernel B launch with nsl 2)
    name, kappa, n, Nb = TWO_SLICE_COMMIT
    rec, ent = plane_commit_shape("two-slice b16", name, kappa, n, Nb, seed, 200, device, flush, False, True)
    record["two-slice b16"] = rec
    entries += ent
    torch.cuda.empty_cache()
    # each fold's commit shape; its kernels JSON entries come with the
    # fold's launches (kernel_entries). The big-m fold's is five slices
    # (five kernel A launches, one kernel B launch with nsl 5)
    folds = [(f"{name} fold", name, preset, kappa, WIT_LEN) for name, (preset, kappa, _) in PATHS.items()]
    folds += [(f"{MODERATE_B[0]} {MODERATE_B[1]} fold", *MODERATE_B, WIT_LEN),
              (f"{BIGM[0]} big-m fold", BIGM[0], PATHS[BIGM[0]][0], BIGM[2], BIGM[1])]
    for label, name, preset, kappa, wit_len in folds:
        dp = getattr(params, preset)
        rec, _ = plane_commit_shape(label, name, kappa, wit_len * dp.L, dp.K - 1, 7, 3, device, flush, False)
        record[label] = rec
        torch.cuda.empty_cache()
    record["babybear contiguous Nb=7"] = check_odd_batch(device)
    return record, entries


def epilogue_inputs(device):
    """Kernel B's inputs at each phase 1b commit shape, one shape at a time:
    yields (label, ring, (ring, P, sM, rows, n, Nb)), P from the Hopper dot
    on a seeded batch."""
    import torch

    from latticefold_torch import params
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.rings import plane_commit as pc
    from latticefold_torch.rings.construct import get_ring

    name, kappa, n, _, batches = BENCH_COMMIT
    shapes = [(f"bench b{Nb}", name, kappa, n, Nb) for Nb in batches]
    shapes.append(("two-slice b16",) + TWO_SLICE_COMMIT)
    shapes += [(f"{name} fold", name, kappa, WIT_LEN * getattr(params, preset).L, getattr(params, preset).K - 1)
               for name, (preset, kappa, _) in PATHS.items()]
    for label, name, kappa, n, Nb in shapes:
        ring = get_ring(name)
        scheme = AjtaiScheme(ring, kappa, n, seed=7, device=device)
        pre = scheme._fused_planes
        fcm = pc.empty_batch(ring, n, Nb, device)
        fcm.copy_(rand_field(ring, (ring.ncomp, n, ring.e, Nb), 3, device))
        w2d = fcm.reshape(ring.ncomp, n, -1)
        P = torch.stack([pc.plane_dot(pre.lhs_i8[:, :, k0 : k0 + pc._K_SLICE], w2d[:, k0 : k0 + pc._K_SLICE])
                         for k0 in range(0, n, pc._K_SLICE)])
        del scheme, fcm, w2d
        yield label, ring, (ring, P, pre.sM, pre.rows, n, Nb)
        del pre, P
        torch.cuda.empty_cache()


def sweep_epilogue_groups(device, groups=(1, 2, 3, 4, 8)):
    """Kernel B's diagonal kernel with 1, 2, 3, 4 and 8 b groups a block
    (the choice ``plane_commit.diag_groups`` makes) at each phase 1b commit
    shape, each equal to the item-per-thread kernel and timed in turns with
    it. Not part of ``main``: ``python3 -c "import chip_smoke as cs; ..."``
    runs it (.claude/skills/verify/SKILL.md). Returns {shape: {key: ms}}."""
    import torch

    from latticefold_torch.rings import plane_commit as pc

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {}
    for label, ring, args in epilogue_inputs(device):
        want = pc.epilogue_items(*args)
        fns = {"items": lambda: pc.epilogue_items(*args)}
        for g in groups:
            if (g - 1) * 32 // (4 * ring.nl) >= args[-1]:  # a whole group past Nb in every block
                continue
            fns[f"nbb={g}"] = lambda g=g: pc._epilogue_kernel("plane_epilogue_diag", *args, g)
            max_abs_err(f"plane_epilogue_diag [{label}] nbb={g}", fns[f"nbb={g}"](), want)
        out[label] = time_in_turns(fns, 20, flush)
        log(f"[sweep B {label}] " + ", ".join(f"{k} {v:.5f} ms" for k, v in out[label].items()))
    return out


# kernel B's phases taken out, one at a time, for ablate_epilogue: (file of
# latticefold_torch/csrc, text, replacement)
EPILOGUE_ABLATIONS = {
    "no loads": [
        ("plane_epilogue_diag.cuh",
         "      copy16(tile + (rowl * 4 + plane) * pitch + j * seg + 4 * q, Pc + grow * N + run(plane, j) + 4 * q);",
         "      if (rowl == E * DA) copy16(tile + (rowl * 4 + plane) * pitch + j * seg + 4 * q, Pc + grow * N + run(plane, j) + 4 * q);"),
        ("plane_epilogue_diag.cuh",
         "w.v[m] = LF_LD_STREAM(prow + m * N + qg[m & 3] + (diag_jb(DA, s, m) >> 2));",
         "w.v[m] = m + qg[m & 3];"),
        ("plane_epilogue_diag.cuh",
         "w.x[m] = Pc[pr.rows * N + qg[m & 3] + (diag_jb(DA, s, m) >> 2)] + sMr[m];",
         "w.x[m] = m;"),
    ],
    "no grouping": [
        ("plane_epilogue_diag_kernel.cu",
         "      blk.group(si, task, tid, blk.DIRECT ? blk.load(si, task, tid) : Words{});",
         "      if (task < 0) blk.group(si, task, tid, Words{});"),
    ],
    "no finish": [
        ("plane_epilogue_diag_kernel.cu",
         "  __syncthreads();\n  blk.finish(tid, nth, wr);",
         "  __syncthreads();\n  if (pr.nsl > 0) return;\n  blk.finish(tid, nth, wr);"),
    ],
}


def ablate_epilogue(device):
    """Kernel B's diagonal kernel beside copies of it built without one
    phase each (EPILOGUE_ABLATIONS: no loads of P, no grouping, no finish
    and fold) and the item-per-thread kernel, timed in turns at each phase
    1b commit shape. The copies are built with the same nvcc command into
    latticefold_torch/_build/ablate. Not part of ``main``; returns {shape:
    {key: ms}}."""
    import ctypes
    import shutil

    import torch

    from latticefold_torch import cuda
    from latticefold_torch.rings import plane_commit as pc

    cuda.build()
    root = os.path.join(cuda.BUILD_DIR, "ablate")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for key, edits in EPILOGUE_ABLATIONS.items():
        src = os.path.join(root, key.replace(" ", "_"))
        shutil.copytree(cuda.CSRC, src)
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            with open(path) as fh:
                text = fh.read()
            if text.count(old) != 1:
                raise AssertionError(f"ablation {key!r}: {old!r} not found once in {fname}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        lib = os.path.join(src, "lib.so")
        procs[key] = (lib, subprocess.Popen(
            [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", lib, os.path.join(src, cuda.SOURCES["plane_epilogue_diag"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (lib, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {key!r} did not build:\n{log_text}")
        _, fn_name, argtypes = cuda._ARGTYPES["plane_epilogue_diag"]
        fn = getattr(ctypes.CDLL(lib), fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[key] = fn
    full = cuda.kernel("plane_epilogue_diag")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def with_fn(fn, args):
        cuda._fns["plane_epilogue_diag"] = fn
        try:
            return pc.epilogue(*args)
        finally:
            cuda._fns["plane_epilogue_diag"] = full

    out = {}
    for label, _, args in epilogue_inputs(device):
        calls = {"full": lambda: pc.epilogue(*args), "items": lambda: pc.epilogue_items(*args)}
        calls.update({key: (lambda fn=fn: with_fn(fn, args)) for key, fn in fns.items()})
        out[label] = time_in_turns(calls, 20, flush)
        log(f"[ablate B {label}] " + ", ".join(f"{k} {v:.5f} ms" for k, v in out[label].items()))
    with open(os.path.join(OUT_DIR, "chip_smoke_ablate.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return out


def check_odd_batch(device):
    """A contiguous BabyBear batch [8, n, 9, 7, 1] at the fold's kappa and n:
    rows of 63 words, not 16 bytes apart, which ``commit_batch_fused`` copies
    into aligned storage before the route; the limbs must equal
    ``commit_batch_cm``'s."""
    import torch

    from latticefold_torch import params
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.rings import plane_commit as pc
    from latticefold_torch.rings.construct import get_ring

    ring, kappa, Nb = get_ring("babybear"), PATHS["babybear"][1], 7
    n = WIT_LEN * params.DP_BABYBEAR.L
    scheme = AjtaiScheme(ring, kappa, n, seed=7, device=device)
    fcm = rand_field(ring, (ring.ncomp, n, ring.e, Nb), 11, device)
    if pc.aligned_batch(ring, fcm) is fcm:
        raise AssertionError("the contiguous odd-Nb batch should not be 16-byte aligned")
    label = f"commit_batch_fused [babybear contiguous Nb={Nb}]"
    got, launches = counted(label, lambda: scheme.commit_batch_fused(fcm),
                            {"plane_dot_sm90": -(-n // pc._K_SLICE), "plane_epilogue_diag": 1})
    if (got != scheme.commit_batch_cm(fcm)).any():
        raise AssertionError(f"{label} differs from commit_batch_cm")
    log(f"[plane commit] {label} kappa={kappa} n={n}: launches {launches}; equal to commit_batch_cm")
    del scheme, fcm, got
    torch.cuda.empty_cache()
    return dict(ring="babybear", kappa=kappa, n=n, Nb=Nb, launches=launches, equal_to_commit_batch_cm=True)


def probe_case(label, kernel, fn, plain, flush, n_bytes, ops, library=None, first=None, library_call=None,
               peak_ops=PEAK_INT8_OPS_PER_S):
    """One probe: counted run (one launch of ``kernel``), exact against the
    plain version, timed beside its bound and the library call (``library``:
    a function returning ms, or ``int_mm_ms``'s two layouts). ``first``:
    the same function on the kernel's first design, held against the plain
    version too (uncounted) and timed in turns with the kernel, 50 runs
    each (the small GEMMs sit near the launch floor, where 20 runs left
    10 % between calls). ``library_call`` (with ``first``): one library call
    of the same function; the kernel, the first design and it are then
    timed in turns over 1000 launches each instead (``probe_turns``: the
    medians are the record's times, the quartiles under ``turns``), for the
    probes whose gaps are a few us."""
    got, launches = counted(label, fn, {kernel: 1})
    want = plain()
    err = max_abs_err(label, got, want)
    del got
    r = dict(max_abs_err=err, launches=launches[kernel])
    if first is None:
        r["ms"] = time_ms(fn, 20, flush)
    else:
        max_abs_err(f"{label} (first design)", first(), want)
        fns = {"kernel": fn, "first": first}
        if library_call is None:
            t = time_in_turns(fns, 50, flush)
        else:
            fns["library"] = library_call
            r["turns"] = t = probe_turns(label, fns, flush)
        host = host_us_in_turns(fns)
        r.update(ms=t["kernel"], first_ms=t["first"], faster_than_first=t["kernel"] < t["first"],
                 host_us=host["kernel"], first_host_us=host["first"])
        if library_call is not None:
            r.update(library_ms=t["library"], library_host_us=host["library"])
    del want
    if library_call is None:
        lib = library() if library else None
        if isinstance(lib, dict):
            r.update(library_ms=lib["b_row_major_ms"], library_b_col_major_ms=lib["b_col_major_ms"])
        else:
            r["library_ms"] = lib
    r.update(plain_ms=time_ms(plain, 2, flush), **roofline(n_bytes, ops, peak_ops))
    extra = ""
    if ops == 0:
        r["gb_per_s"] = n_bytes / (r["ms"] / 1e3) / 1e9
        extra = f", {r['gb_per_s']:.1f} GB/s of {PEAK_BYTES_PER_S / 1e9:.0f}"
    if first is not None:
        extra += (f"; first design {r['first_ms']:.4f} ms in turns; host us a call {r['host_us']:.2f}, first "
                  f"design {r['first_host_us']:.2f}")
    if "library_host_us" in r:
        extra += f", library {r['library_host_us']:.2f}"
    if "library_b_col_major_ms" in r:
        extra += f"; _int_mm B column-major {r['library_b_col_major_ms']}"
    log(f"[probe {label}] {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} {r['bound_by']}{extra}), plain "
        f"{r['plain_ms']:.3f} ms, library {r['library_ms']}; exact")
    return r


def probe_turns(label, fns: dict, flush, reps=1000):
    """A one-launch probe (key ``kernel``) against its first design and one
    library call of the same function, in turns over ``reps`` launches each
    (the L2 flushed before each: ``turn_samples``), with the spread of each:
    the first and third quartiles."""
    t = {}
    for k, v in turn_samples(fns, reps, flush).items():
        q1, med, q3 = statistics.quantiles(v, n=4)
        t[k], t[f"{k}_q1"], t[f"{k}_q3"] = med, q1, q3
    t["reps"] = reps
    log(f"[probe {label}] in turns over {reps} launches each (median [q1, q3]): "
        + ", ".join(f"{k} {t[k]:.6f} [{t[f'{k}_q1']:.6f}, {t[f'{k}_q3']:.6f}] ms" for k in fns))
    return t


def bf16_mm_fn(x, y, want):
    """P5 dot_u8_via_bf16's library call: ``torch.mm`` of the bf16 casts with
    a float32 ``out_dtype`` (exact: the u8 values and their products' sums
    are exact in bf16 and float32), the casts made here, outside any
    timing. Raises where the card's torch does not take that argument or
    the result differs from the plain version (a bf16 output rounds and is
    no yardstick)."""
    import torch

    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    got = torch.mm(xb, yb, out_dtype=torch.float32)
    if got.dtype != torch.float32 or not torch.equal(got, want):
        raise AssertionError("torch.mm(out_dtype=float32) does not equal the plain version")
    return lambda: torch.mm(xb, yb, out_dtype=torch.float32)


def bf16_case(label, u8, flush):
    """P5 dot_u8_via_bf16: the Hopper kernel counted (one launch of
    ``bf16_gemm_sm90`` a call) and, with its first design, equal to the
    plain version at a ragged 72 x 200 x 40 and at all-255 operands at K
    256 (the top of the exact range, sums 16646400), then ``probe_case`` at
    128 x 128 x 128 with ``torch.mm`` of the bf16 casts as its library
    call."""
    import torch

    from latticefold_torch.rings import plane_probes as pp

    full = lambda *shape: torch.full(shape, 255, dtype=torch.uint8, device=flush.device)  # noqa: E731
    for name, (x, y) in {"72x200x40": (u8(72, 200), u8(200, 40)),
                         "128x256x128 all 255": (full(128, 256), full(256, 128))}.items():
        got, _ = counted(f"{label} {name}", lambda: pp.bf16_gemm(x, y), {"bf16_gemm_sm90": 1})
        want = pp.bf16_gemm_plain(x, y)
        max_abs_err(f"{label} {name}", got, want)
        max_abs_err(f"{label} {name} (first design)", pp.bf16_gemm_mma(x, y), want)
    x, y = u8(128, 128), u8(128, 128)
    r = probe_case(label, "bf16_gemm_sm90", lambda: pp.bf16_gemm(x, y), lambda: pp.bf16_gemm_plain(x, y), flush,
                   2 * 128 * 128 + 128 * 128 * 4, 2 * 128**3, first=lambda: pp.bf16_gemm_mma(x, y),
                   library_call=bf16_mm_fn(x, y, pp.bf16_gemm_plain(x, y)), peak_ops=PEAK_BF16_OPS_PER_S)
    r.update(exact_at=["128x128x128", "72x200x40", "128x256x128 all 255"], library_note="torch.mm(bf16, "
             "out_dtype=float32)", at_or_below_library=r["ms"] <= r["library_ms"])
    return r


def check_probes(device):
    """Phase 1b, the TPU probes P1-P5 at their TPU shapes; each kernel
    redesigned for Hopper timed in turns with its first design."""
    import torch

    from latticefold_torch.rings import plane_commit as pc
    from latticefold_torch.rings import plane_probes as pp

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def i8(*shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=device, generator=gen)

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)

    def u32(*shape):
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64, device=device, generator=gen).to(torch.int32)

    C, M, K = PROBE_C, PROBE_MPAD, PROBE_K
    cases = {}
    for Nb in (16, 64):
        L = 3 * Nb * 2
        a, w = i8(C, M, K), u32(C, K, L)
        at = a.transpose(1, 2).contiguous()
        planes = pc._signed_planes(w, "full").to(torch.int8)
        fake = pc._signed_planes(w, "dot_only").to(torch.int8)
        dot_bytes = C * M * K + C * K * L * 4 + C * M * 4 * L * 4
        dot_ops = 2 * C * M * K * 4 * L
        lib = lambda p: int_mm_ms([(a[ci], p[ci]) for ci in range(C)], flush)  # noqa: E731
        tag = f"L={L}"
        cases[f"P1 v1 {tag}"] = probe_case(
            f"P1 v1 {tag}", "plane_dot", lambda: pp.plane_dot_mma(a, w), lambda: pc.plane_dot_plain(a, w),
            flush, dot_bytes, dot_ops, library=lambda: lib(planes))
        cases[f"P1 v2 {tag}"] = probe_case(
            f"P1 v2 {tag}", "plane_dot_sm90", lambda: pp.plane_dot(a, w), lambda: pc.plane_dot_plain(a, w),
            flush, dot_bytes, dot_ops, library=lambda: lib(planes))
        cases[f"P1 planes_only {tag}"] = probe_case(
            f"P1 planes_only {tag}", "plane_dot", lambda: pp.plane_dot(a, w, "planes_only"),
            lambda: pc.plane_dot_plain(a, w, "planes_only"), flush, C * K * L * 4 + C * M * 4 * L * 4, 0)
        cases[f"P1 dot_only {tag}"] = probe_case(
            f"P1 dot_only {tag}", "plane_dot_sm90", lambda: pp.plane_dot(a, w, "dot_only"),
            lambda: pc.plane_dot_plain(a, w, "dot_only"), flush, dot_bytes, dot_ops, library=lambda: lib(fake),
            first=lambda: pp.plane_dot_mma(a, w, "dot_only"))
        cases[f"P2 batched {tag}"] = probe_case(
            f"P2 batched {tag}", "plane_dot_sm90", lambda: pp.plane_dot(a, w), lambda: pc.plane_dot_plain(a, w),
            flush, dot_bytes, dot_ops, library=lambda: lib(planes))
        cases[f"P2 dma {tag}"] = probe_case(
            f"P2 dma {tag}", "dma_checksum", lambda: pp.dma_checksum(a, w), lambda: pp.dma_checksum_plain(a, w),
            flush, C * M * K + C * K * L * 4 + C * 4, 0)
        cases[f"P3 kmajor {tag}"] = probe_case(
            f"P3 kmajor {tag}", "plane_dot_sm90", lambda: pp.plane_dot(at, w, kmajor=True),
            lambda: pc.plane_dot_plain(at, w, kmajor=True), flush, dot_bytes, dot_ops,
            library=lambda: int_mm_ms([(at[ci].t(), planes[ci]) for ci in range(C)], flush),
            first=lambda: pp.plane_dot_mma(at, w, kmajor=True))
        cases[f"P3 dma {tag}"] = probe_case(
            f"P3 dma {tag}", "dma_checksum", lambda: pp.dma_checksum(at, w), lambda: pp.dma_checksum_plain(at, w),
            flush, C * M * K + C * K * L * 4 + C * 4, 0)
        del a, w, at, planes, fake
        torch.cuda.empty_cache()

    def gemm(label, x, y, library=True):
        (m, k), nn = x.shape, y.shape[1]
        out_bytes = m * nn * 4
        cases[label] = probe_case(
            label, "int_gemm_sm90", lambda: pp.int_gemm(x, y), lambda: pp.int_gemm_plain(x, y), flush,
            m * k * x.element_size() + k * nn * y.element_size() + out_bytes, 2 * m * nn * k,
            library=(lambda: int_mm_ms([(x, y)], flush)) if library else None, first=lambda: pp.int_gemm_mma(x, y))

    gemm("P4 i8exact s8 256x2048x256", i8(256, 2048), i8(2048, 256))
    gemm("P4 i8exact u8 256x2048x256", u8(256, 2048), u8(2048, 256), library=False)
    gemm("P4 i8exact s8 8x32768x128", i8(8, 1 << 15), i8(1 << 15, 128))
    for nn in (384, 1536):
        gemm(f"P4 dotspeed s8 1728x32768x{nn}", i8(1728, 1 << 15), i8(1 << 15, nn))
    gemm("P5 dot_u8 128x256x128", u8(128, 256), u8(256, 128), library=False)
    cases["P5 dot_u8_via_bf16 128x128x128"] = bf16_case("P5 dot_u8_via_bf16 128x128x128", u8, flush)
    xb = u32(8, 128)
    cases["P5 bitcast 8x128"] = probe_case(
        "P5 bitcast 8x128", "bitcast", lambda: pp.bitcast_u8(xb), lambda: xb.view(torch.uint8), flush,
        2 * xb.numel() * 4, 0, first=lambda: pp.bitcast_u8_v1(xb), library_call=lambda: xb.view(torch.uint8).clone())
    ym = u32(8, 16, 4)
    cases["P5 merge 8x16x4"] = probe_case(
        "P5 merge 8x16x4", "merge", lambda: pp.merge_minor(ym), lambda: ym.reshape(8, 64), flush,
        2 * ym.numel() * 4, 0, first=lambda: pp.merge_minor_v1(ym), library_call=lambda: ym.reshape(8, 64).clone())
    entries = []
    for label, r in cases.items():
        key = PROBE_KERNEL[label.split()[0] + " " + label.split()[1]]
        extra = {k: r[k] for k in ("first_ms", "faster_than_first", "host_us", "first_host_us", "library_host_us",
                                   "library_b_col_major_ms", "turns", "library_note", "exact_at",
                                   "at_or_below_library") if k in r}
        entries.append(dict(KERNEL_INFO[key], name=f"{KERNEL_INFO[key]['name']}[{label}]",
                            replaces=PROBE_REPLACES[label.split()[0] + " " + label.split()[1]],
                            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], shape=label, **extra))
        if "turns" in r:  # the first design, timed in the same turns, off every path
            first = PROBE_FIRST[label.split()[0] + " " + label.split()[1]]
            entries.append(dict(KERNEL_INFO[first], name=f"{KERNEL_INFO[first]['name']}[{label}]",
                                replaces=PROBE_REPLACES[label.split()[0] + " " + label.split()[1]], launches=0,
                                max_abs_err=r["max_abs_err"], ms=r["turns"]["first"],
                                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                                library_ms=r["library_ms"], shape=label, on_main_path=False))
    del flush
    torch.cuda.empty_cache()
    return cases, entries


KERNEL_INFO = {
    "crt_tc": dict(
        name="crt_tc_kernel", route="cuda", source="latticefold_torch/csrc/crt_tc_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_crt.py:105",
    ),
    "crt": dict(
        name="crt_kernel", route="cuda", source="latticefold_torch/csrc/crt_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_crt.py:105",
    ),
    "commit_sm90": dict(
        name="commit_sm90_kernel", route="cuda", source="latticefold_torch/csrc/commit_sm90_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_commit.py:136,179",
    ),
    "commit": dict(
        name="commit_kernel", route="cuda", source="latticefold_torch/csrc/commit_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_commit.py:136,179",
    ),
    "plane_dot": dict(
        name="plane_dot_kernel", route="cuda", source="latticefold_torch/csrc/plane_dot_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_commit.py:136",
    ),
    "plane_dot_sm90": dict(
        name="plane_dot_sm90_kernel", route="cuda", source="latticefold_torch/csrc/plane_dot_sm90_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_commit.py:136",
    ),
    "plane_epilogue_diag": dict(
        name="plane_epilogue_diag_kernel", route="cuda",
        source="latticefold_torch/csrc/plane_epilogue_diag_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_commit.py:180",
    ),
    "plane_epilogue": dict(
        name="plane_epilogue_kernel", route="cuda", source="latticefold_torch/csrc/plane_epilogue_kernel.cu",
        replaces="latticefold_tpu/rings/pallas_commit.py:180",
    ),
    "int_gemm": dict(name="int_gemm_kernel", route="cuda", source="latticefold_torch/csrc/int_gemm_kernel.cu"),
    "int_gemm_sm90": dict(name="int_gemm_sm90_kernel", route="cuda",
                          source="latticefold_torch/csrc/int_gemm_sm90_kernel.cu"),
    "bf16_gemm_sm90": dict(name="bf16_gemm_sm90_kernel", route="cuda",
                           source="latticefold_torch/csrc/bf16_gemm_sm90_kernel.cu"),
    "dma_checksum": dict(name="dma_checksum_kernel", route="cuda",
                         source="latticefold_torch/csrc/probe_kernels.cu"),
    "bitcast": dict(name="bitcast_u8_vec_kernel", route="cuda", source="latticefold_torch/csrc/probe_kernels.cu"),
    "merge": dict(name="merge_minor_vec_kernel", route="cuda", source="latticefold_torch/csrc/probe_kernels.cu"),
    "bitcast_v1": dict(name="bitcast_u8_kernel", route="cuda", source="latticefold_torch/csrc/probe_kernels.cu"),
    "merge_v1": dict(name="merge_minor_kernel", route="cuda", source="latticefold_torch/csrc/probe_kernels.cu"),
    "poseidon": dict(name="poseidon_sponge_kernel", route="cuda",
                     source="latticefold_torch/csrc/poseidon_kernel.cu",
                     replaces="latticefold_tpu/transcript/device.py:74"),
    "poseidon_perm": dict(name="poseidon_kernel", route="cuda", source="latticefold_torch/csrc/poseidon_kernel.cu",
                          replaces="latticefold_tpu/transcript/device.py:74"),
}
# probe (the first two words of its label) -> its kernel, and the TPU kernel it replaces
PROBE_KERNEL = {
    "P1 v1": "plane_dot", "P1 v2": "plane_dot_sm90", "P1 planes_only": "plane_dot", "P1 dot_only": "plane_dot_sm90",
    "P2 batched": "plane_dot_sm90", "P2 dma": "dma_checksum", "P3 kmajor": "plane_dot_sm90", "P3 dma": "dma_checksum",
    "P4 i8exact": "int_gemm_sm90", "P4 dotspeed": "int_gemm_sm90", "P5 dot_u8": "int_gemm_sm90",
    "P5 dot_u8_via_bf16": "bf16_gemm_sm90", "P5 bitcast": "bitcast", "P5 merge": "merge",
}
# probe -> its kernel's first design, timed in the same turns and listed off every path
PROBE_FIRST = {"P5 dot_u8_via_bf16": "int_gemm", "P5 bitcast": "bitcast_v1", "P5 merge": "merge_v1"}
PROBE_REPLACES = {
    "P1 v1": "benches/exp_r4_kvar.py:60",
    "P1 v2": "benches/exp_r4_kvar.py:74",
    "P1 planes_only": "benches/exp_r4_kvar.py:88",
    "P1 dot_only": "benches/exp_r4_kvar.py:102",
    "P2 batched": "benches/exp_r4_kvar2.py:43",
    "P2 dma": "benches/exp_r4_kvar2.py:58",
    "P3 kmajor": "benches/exp_r4_kvar3.py:54",
    "P3 dma": "benches/exp_r4_kvar3.py:68",
    "P4 i8exact": "benches/exp_r4_probe.py:72,97,118",
    "P4 dotspeed": "benches/exp_r4_probe.py:193",
    "P5 dot_u8": "benches/exp_pallas_probe.py:52",
    "P5 dot_u8_via_bf16": "benches/exp_pallas_probe.py:71",
    "P5 bitcast": "benches/exp_pallas_probe.py:32",
    "P5 merge": "benches/exp_pallas_probe.py:93",
}


def peak_sweep(device, wit_lens=(8192, 16384, 32768)):
    """The peak device memory of each fold path against m: Goldilocks at
    DP_GOLDILOCKS (kappa 9, the e2e chain's instance) at each wit_len,
    forced onto the standard path and, at the largest, onto the big-m path
    too; one prove each. A prove that runs out of device memory is
    recorded as such. The numbers behind the port's path rule
    (``nifs.STANDARD_PEAK_BYTES_PER_CONSTRAINT``, ``STANDARD_PEAK_SHARE``).
    Not run by ``main``: call it alone. Writes
    chiprun_out/chip_smoke_peaks.json."""
    import torch

    from latticefold_torch import cuda, e2e, nifs
    from latticefold_torch.transcript import Transcript

    out = []
    for wit_len in wit_lens:
        s = e2e.setup_chain("goldilocks", wit_len, X_LEN, 9, device)
        for big_m in (False, True) if wit_len == wit_lens[-1] else (False,):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            live = torch.cuda.memory_allocated(device)
            cuda.reset_launches()
            rec = dict(wit_len=wit_len, m=s.ccs.m, big_m=big_m, live_bytes=live)
            t0 = time.perf_counter()
            try:
                nifs.prove(s.acc0, s.wit, s.cm_i, s.wit, Transcript(s.ring), s.ccs, s.scheme, s.dp, big_m=big_m)
                torch.cuda.synchronize()
                rec.update(prove_s=time.perf_counter() - t0, peak_bytes=torch.cuda.max_memory_allocated(device),
                           reserved_bytes=torch.cuda.max_memory_reserved(device),
                           launches={k: v for k, v in cuda.LAUNCHES.items() if v})
                rec["peak_per_constraint"] = rec["peak_bytes"] / s.ccs.m
            except torch.OutOfMemoryError as e:
                rec["out_of_memory"] = str(e).splitlines()[0]
            log(f"[peaks] {rec}")
            out.append(rec)
        del s
    torch.cuda.empty_cache()
    with open(os.path.join(OUT_DIR, "chip_smoke_peaks.json"), "w") as fh:
        json.dump(dict(card=nvidia_smi_line(), total_memory=torch.cuda.get_device_properties(device).total_memory,
                       runs=out), fh, indent=1)
    return out


def kernel_entries(label, name, n, Nb, kres, launches, route_rec, kappa=None, permutations=0):
    """The ``kernels`` JSON entries of one path (``label``, on ring ``name``
    at Ajtai width ``n``): each kernel at the shape the prove launches it at
    (the CRTs at crt N = n; the Hopper dot, the epilogue and the commit
    kernel at Nb = K - 1 for a fold, the commit kernel where phase 2
    measured that shape), with the other shapes beside it and ``launches``
    from the path's counted prove. A kernel the path does not launch (on a
    fold the SIMT CRT and the commit kernel) is marked off the main path.
    ``route_rec``: the fold's phase 1b record, or None on a path that does
    not take the byte-plane route (then ``kappa`` is given).
    ``permutations``: the Poseidon kernel's permutations in that prove."""
    if route_rec is None:
        entries = []
    else:
        kappa = route_rec["kappa"]
        entries = route_entries(label, route_rec, launches)
    from latticefold_torch.rings.construct import get_ring

    for key, main in (("crt_tc", f"crt N={n}"), ("crt", f"crt N={n}"),
                      ("commit_sm90", f"kappa={kappa} n={n} Nb={Nb}"), ("commit", f"kappa={kappa} n={n} Nb={Nb}"),
                      ("poseidon", poseidon_shape(get_ring(name))),
                      ("poseidon_perm", poseidon_shape(get_ring(name)))):
        if (key, main) not in kres:
            continue
        r = kres[(key, main)]
        info = dict(KERNEL_INFO[key])
        info["name"] = f"{info['name']}[{label}]"
        extra = {}
        if key == "crt_tc":
            extra = dict(simt_ms=r["simt_ms"], lane_floor_ms=r["lane_floor"]["bound_ms"],
                         conv_plain_ms=r["conv_plain_ms"], int_mm_dot_ms=r["int_mm_ms"],
                         int_mm_dot_b_col_major_ms=r["int_mm_b_col_major_ms"])
        elif key == "commit_sm90":
            extra = {k: r[k] for k in ("lane_floor_ms", "old_ms", "route_ms", "pass1_ms", "pass2_ms")}
        elif key == "commit":
            extra = dict(lane_floor_ms=r["lane_floor_ms"], new_ms=r["new_ms"])
        elif key == "poseidon":
            extra = {k: r[k] for k in ("first_ms", "warm_ms", "first_warm_ms", "per_permutation", "launch_floor_ms",
                                       "chain_ms", "first_chain_ms", "latency_bound_ms", "max_sm_clock_mhz")}
            extra["permutations"] = permutations
            extra["note"] = ("replaces no Pallas kernel: the JAX package's permute is XLA; one launch per absorb "
                             "call and per squeeze call that permutes")
        elif key == "poseidon_perm":
            extra = {k: r[k] for k in ("warm_ms", "new_ms", "launch_floor_ms", "chain_ms", "latency_bound_ms")}
            extra["note"] = "the first design (one permutation a launch): the sponge kernel's in-call baseline"
        entries.append(dict(
            info, ring=name, launches=launches.get(key, 0), max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape=main, on_main_path=launches.get(key, 0) > 0, **extra,
            other_shapes={s: {k: v for k, v in rec.items() if k not in ("lane_floor", "plan")}
                          for (k, s), rec in kres.items() if k == key and s != main},
        ))
    return entries


def run_moderate_b_phase(device, kres, plane_rec):
    """Phase 3c: the fold phase's instance at MODERATE_B's preset (one
    counted prove: the tensor-core CRT 2K + 1, the Hopper dot 2 and the
    diagonal epilogue 2 launches, nothing else; verified, w0 opens).
    ``kres``: phase 2's records of the ring (the CRT shapes are the fold
    phase's). Returns (record, kernels JSON entries)."""
    import torch

    from latticefold_torch import params
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.rings.construct import get_ring

    name, preset, kappa = MODERATE_B
    dp = getattr(params, preset)
    label = f"{name} {preset}"
    scheme = AjtaiScheme(get_ring(name), kappa, WIT_LEN * dp.L, seed=7, device=device)
    fold = run_fold(name, dp, scheme, 0, device, label=label)
    fold.pop("proof_bytes")
    entries = kernel_entries(label, name, scheme.n, dp.K - 1, kres, fold["launches"], plane_rec[f"{label} fold"])
    del scheme
    torch.cuda.empty_cache()
    return dict(fold=fold), entries


def run_bigm_phase(device, std_fold, std_proof, kres_std, plane_rec):
    """Phase 3d: (1) the fold phase's Goldilocks instance forced onto the
    big-m path (``big_m=True``, BIGM_EXPAND_NVARS): its proof bytes must be
    the fold phase's counted prove's; (2) BIGM's instance through
    ``latticefold_torch.e2e`` with no path asked for: the rule must choose
    the big-m path; one counted prove (the tensor-core CRT 2K + 1, the
    Hopper dot once per 2^15-term slice of each batch commit, the diagonal
    epilogue 2, nothing else), verified, w0 opens, peak under
    PEAK_SHARE_MAX of the card. Phase 2 holds the kernels at (2)'s shapes
    first. Returns (record, kernels JSON entries)."""
    import torch

    from latticefold_torch import e2e, nifs, params
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.rings.construct import get_ring
    from latticefold_torch.transcript import Transcript

    name, wit_len, kappa = BIGM
    dp = getattr(params, PATHS[name][0])
    label = f"{name} big-m m=2^15"
    scheme = AjtaiScheme(get_ring(name), kappa, WIT_LEN * dp.L, seed=7, device=device)
    forced = run_fold(name, dp, scheme, 0, device, label=label, big_m=True, expect_big_m=True)
    if forced.pop("proof_bytes") != std_proof:
        raise AssertionError(f"[{label}] the proof differs from the standard path's")
    log(f"[{label}] the proof bytes equal the standard path's; peak device memory {forced['peak_bytes']} B "
        f"against the standard path's {std_fold['peak_bytes']} B")
    entries = kernel_entries(label, name, scheme.n, dp.K - 1, kres_std, forced["launches"],
                             plane_rec[f"{name} fold"])
    del scheme
    torch.cuda.empty_cache()

    label = f"{name} big-m m=2^18"
    s = e2e.setup_chain(name, wit_len, X_LEN, kappa, device)
    ring = s.ring
    log(f"[{label}] wit_len={wit_len} m={s.ccs.m} n={s.scheme.n} kappa={kappa}: setup {s.setup_s:.2f} s")
    kres = check_kernels(label, dp, s.scheme, device, wit_len)
    with bigm_calls() as calls:
        acc, w_acc, step = e2e.prove_step(s, s.acc0, s.wit)
    expected = prove_launches(dp, s.scheme.n)
    log(f"[{label}] prove {step.prove_s:.3f} s, peak device memory {step.peak_bytes} B ({step.live_bytes} B "
        f"held at its start), launches {step.launches}, path {'big-m' if calls[0] else 'standard'}")
    if not (step.big_m and calls[0] == 1):
        raise AssertionError(f"[{label}] the rule did not choose the big-m path")
    if step.launches != expected:
        raise AssertionError(f"[{label}] launches {step.launches}, expected {expected}")
    total = check_peak(label, step.peak_bytes, device)
    t0 = time.perf_counter()
    folded_v = nifs.verify(s.acc0, s.cm_i, step.proof, Transcript(ring), s.ccs, dp)
    verify_s = time.perf_counter() - t0
    if (folded_v.r, folded_v.v, folded_v.u, folded_v.cm) != (acc.r, acc.v, acc.u, acc.cm):
        raise AssertionError(f"[{label}] the verifier's folded accumulator differs from the prover's")
    if w_acc.commit(s.scheme) != acc.cm:
        raise AssertionError(f"[{label}] the folded witness does not open the folded commitment")
    log(f"[{label}] verify {verify_s:.3f} s: verifier accepts; w0 opens the folded commitment; peak "
        f"{step.peak_bytes / total:.3f} of the card's {total} B")
    big = dict(wit_len=wit_len, m=s.ccs.m, n=s.scheme.n, kappa=kappa, setup_s=s.setup_s, prove_s=step.prove_s,
               verify_s=verify_s, peak_bytes=step.peak_bytes, live_bytes=step.live_bytes,
               reserved_bytes=torch.cuda.max_memory_reserved(device), total_memory=total,
               launches=step.launches)
    entries += kernel_entries(label, name, s.scheme.n, dp.K - 1, kres, step.launches,
                              plane_rec[f"{name} big-m fold"])
    del s, acc, w_acc, step, folded_v
    torch.cuda.empty_cache()
    return dict(forced_m15=forced, m18=big, kernels={f"{k}:{sh}": v for (k, sh), v in kres.items()}), entries


def plus_launches(L: int, n: int, calls: int, k: int, n_lin: int = 1) -> dict:
    """The launches of one ``PlusProver.prove`` of ``n_lin`` instances of
    width n that folds L instances (``n_lin`` of them new) at k digits: an
    ICRT in each ``RgInstance.from_f``, the ICRT and two CRTs of
    ``decompose``, and an ICRT of each round message of the ring-mode
    sumchecks (each linearization's and ``cm``'s two, log n rounds each:
    ``plus.sumcheck.prove_device`` absorbs coefficients) on the tensor-core
    CRT; in each ``from_f`` one batch commit per group of at most
    ``rgchk.mf_group_cols`` of its k d monomial columns and one of the
    rest, and one in ``decompose``, on the Hopper commit kernel; the
    Poseidon sponge kernel once for each of the ``calls`` absorb calls and
    squeeze calls that permute of the sumchecks' device transcripts (three a
    round); nothing else (the first commit kernel 0)."""
    from latticefold_torch.plus import rgchk
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    groups = -(-k * ring.d // rgchk.mf_group_cols(ring, n))
    return {"crt_tc": L + 3 + (n_lin + 2) * (n - 1).bit_length(), "commit_sm90": L * (groups + 1) + 1,
            "poseidon": calls}


@contextlib.contextmanager
def plus_device_rounds(acc: dict):
    """While the block runs, every ``plus.sumcheck._device_rounds`` (the
    round loop of ``prove_device``) runs under sync debug "error", and
    ``acc["perms"]`` counts the permutations its schedule implies (a
    ``transcript.device.GhostSponge`` from the device sponge's bookkeeping:
    per round an absorb of (degree + 1) d coefficients, a squeeze and an
    absorb of the challenge), ``acc["launches"]`` the sponge kernel's
    launches it implies, ``acc["calls"]`` the calls, and ``acc["host_perms"]``
    the permutations the host transcript makes inside ``prove_device``
    (``sumcheck_host_perms``)."""
    from latticefold_torch.plus import sumcheck as psc
    from latticefold_torch.transcript import device as dtr

    orig, orig_prove = psc._device_rounds, psc.prove_device

    def rounds(ring, sp, mles, nvars, degree, comb, consts):
        g = dtr.GhostSponge(ring, sp.index, sp.absorbing)
        for _ in range(nvars):
            g.absorb((degree + 1) * ring.d)
            g.squeeze(1)
            g.absorb(1)
        acc["perms"] = acc.get("perms", 0) + g.perms
        acc["launches"] = acc.get("launches", 0) + g.launches
        acc["calls"] = acc.get("calls", 0) + 1
        return no_sync(orig)(ring, sp, mles, nvars, degree, comb, consts)

    psc._device_rounds = rounds
    psc.prove_device = sumcheck_host_perms(orig_prove, acc)
    try:
        yield acc
    finally:
        psc._device_rounds, psc.prove_device = orig, orig_prove


def sumcheck_host_perms(prove, acc: dict):
    """A LatticeFold+ sumcheck prover (``prove_host`` or ``prove_device``)
    that adds to ``acc["host_perms"]`` the permutations its host transcript
    makes in the call (``host_permutations``). ``prove_device`` absorbs two
    headers on the host and the rounds on the device, ``prove_host`` both
    on the host: on the same transcript the device's permutations are the
    difference of the two counts."""
    def run(ring, transcript, *args, **kw):
        with host_permutations(type(transcript.sponge), ring) as perms:
            out = prove(ring, transcript, *args, **kw)
            acc["host_perms"] = acc.get("host_perms", 0) + perms()
        return out
    return run


@contextlib.contextmanager
def plus_host_sumchecks(acc: dict):
    """The LatticeFold+ sumchecks on the host transcript (``prove_host``)
    while the block runs, whatever the tables' device; ``acc["host_perms"]``
    counts their permutations (``sumcheck_host_perms``)."""
    from latticefold_torch.plus import sumcheck as psc

    orig = psc.prove
    psc.prove = sumcheck_host_perms(psc.prove_host, acc)
    try:
        yield acc
    finally:
        psc.prove = orig


def plus_setup(n, k, kappa, B, device):
    """The LatticeFold+ instance of benches/run.py:253-264 (and
    tests/test_plus.py's ``_plus_setup``) on Frog at (n, k, kappa, B): the
    identity R1CS of m = n / k constraints through
    ``r1cs_decomposed_square``, z all ones, Ajtai seed 7. On the card
    ``ComR1CS.new`` is counted: crt_tc 2 (the ICRT of z, the CRT of f) and
    commit_sm90 1. Returns (scheme, ComR1CS, PlusParameters)."""
    import math

    from latticefold_torch.arith.sparse import SparseMatrix
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.plus import ComR1CS, DecompParameters, LinParameters, PlusParameters
    from latticefold_torch.plus.r1cs import r1cs_decomposed_square
    from latticefold_torch.rings import ops
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    m = n // k
    b = ring.d // 2
    dparams = DecompParameters(b=b, k=k, l=math.ceil(math.log(ring.q) / math.log(b)))
    ident = SparseMatrix(ring, m, m, [[(1, i)] for i in range(m)])
    mats = r1cs_decomposed_square(ring, ident, ident, ident, n, B, k)
    scheme = AjtaiScheme(ring, kappa, n, seed=7, device=device)
    # z all ones: the one element made once and repeated on the device
    z = ops.to_device(ring, [ring.crt_host([1] + [0] * (ring.d - 1))], device).expand(m, -1, -1, -1).contiguous()

    def new():
        return ComR1CS.new(ring, list(mats), z, 1, B, k, scheme)

    c = counted("ComR1CS.new", new, {"crt_tc": 2, "commit_sm90": 1})[0] if device.type == "cuda" else new()
    return scheme, c, PlusParameters(lin=LinParameters(kappa=kappa, decomp=dparams), B=B)


@contextlib.contextmanager
def plus_timers(acc: dict):
    """Adds the seconds of the LatticeFold+ prover's parts to ``acc[name]``
    while the block runs (to a device synchronize): its subprotocols
    (``r1cs.linearize``, ``RgInstance.from_f``, ``Rg.range_check`` -- the
    set check and the openings --, each of ``cm``'s two batched sumchecks
    ``_sumchecker``, ``decomp.decompose``) and its costliest host loops
    (``cm.calculate_t_z``, the split of the commitment into tau
    ``rgchk.split``, ``cm._comh``) and host loops over n (the transpose
    products ``SparseMatrix.transpose_mul_scalar_host`` of the set check's
    and range check's openings, the ELL build ``SparseMatrix._device`` at
    a matrix's first product, ``r1cs.gadget_decompose_matrix`` in the
    setup)."""
    import torch

    from latticefold_torch.arith.sparse import SparseMatrix
    from latticefold_torch.plus import cm, decomp, r1cs, rgchk

    targets = ((r1cs, "linearize"), (rgchk.RgInstance, "from_f"), (rgchk.Rg, "range_check"),
               (cm, "_sumchecker"), (decomp, "decompose"), (cm, "calculate_t_z"), (rgchk, "split"),
               (cm, "_comh"), (SparseMatrix, "transpose_mul_scalar_host"), (SparseMatrix, "_device"),
               (r1cs, "gadget_decompose_matrix"))
    saved = [(owner, name, owner.__dict__[name]) for owner, name in targets]

    def wrap(name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        return timed

    for owner, name, fn in saved:
        setattr(owner, name, classmethod(wrap(name, fn.__func__)) if isinstance(fn, classmethod) else wrap(name, fn))
    try:
        yield acc
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def plus_part_peaks(acc: dict, device):
    """While the block runs, ``acc[name]`` is the peak device memory (bytes
    allocated) during each part of the LatticeFold+ prover that holds a
    large tensor (``r1cs.linearize``, ``RgInstance.from_f``,
    ``Rg.range_check``, ``cm._h_vectors``, ``cm._build_cm_mles``, each
    ``cm._sumchecker``, ``decomp.decompose``); the peak statistics are reset
    around each part, so after the block ``acc["all"]`` and
    ``acc["reserved"]`` hold the block's peaks allocated and reserved."""
    import torch

    from latticefold_torch.plus import cm, decomp, r1cs, rgchk

    targets = ((r1cs, "linearize"), (rgchk.RgInstance, "from_f"), (rgchk.Rg, "range_check"),
               (cm, "_h_vectors"), (cm, "_build_cm_mles"), (cm, "_sumchecker"), (decomp, "decompose"))
    saved = [(owner, name, owner.__dict__[name]) for owner, name in targets]
    top = {"all": 0, "reserved": 0}

    def fold_in():
        top["all"] = max(top["all"], torch.cuda.max_memory_allocated(device))
        top["reserved"] = max(top["reserved"], torch.cuda.max_memory_reserved(device))
        torch.cuda.reset_peak_memory_stats(device)

    def wrap(name, fn):
        def measured(*args, **kw):
            fold_in()
            try:
                return fn(*args, **kw)
            finally:
                acc[name] = max(acc.get(name, 0), torch.cuda.max_memory_allocated(device))
                fold_in()
        return measured

    for owner, name, fn in saved:
        setattr(owner, name, classmethod(wrap(name, fn.__func__)) if isinstance(fn, classmethod) else wrap(name, fn))
    try:
        yield acc
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        fold_in()
        acc.update(top)


def plus_round(label, prover, c, L, device, host_sumchecks=False, n_lin=1):
    """One ``PlusProver.prove`` of ``n_lin`` copies of the instance ``c``
    that folds L instances, counted (``plus_launches``; with
    ``host_sumchecks`` the sumchecks take ``prove_host``: no Poseidon
    kernel, no ICRT of round messages). The sponge kernel's permutations
    must equal its schedule's (``check_permutations``); the record's
    ``sumcheck_host_perms`` are the host transcript's inside the sumchecks.
    Times the sponge and the prover's parts (``plus_timers``), and takes
    each part's peak device memory (``plus_part_peaks``). Returns (proof,
    record)."""
    import torch

    from latticefold_torch import cuda
    from latticefold_torch.native import NativeSponge

    sponge_cls = type(prover.transcript.sponge)
    if sponge_cls is not NativeSponge:
        raise AssertionError("the native Poseidon sponge did not build or load (g++ on PATH?)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    live = torch.cuda.memory_allocated(device)
    sponge, parts, dev_rounds, peaks = {"s": 0.0}, {}, {}, {}
    ctx = plus_host_sumchecks(dev_rounds) if host_sumchecks else plus_device_rounds(dev_rounds)
    cuda.reset_launches()
    t0 = time.perf_counter()
    with sponge_timer(sponge_cls, sponge), plus_timers(parts), plus_part_peaks(peaks, device), ctx:
        proof = prover.prove([c] * n_lin)
        torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    n, k = c.f.shape[0], prover.params.lin.decomp.k
    expected = plus_launches(L, n, dev_rounds.get("launches", 0), k, n_lin)
    perms = dev_rounds.get("perms", 0)
    if host_sumchecks:
        expected = {"crt_tc": L + 3, "commit_sm90": expected["commit_sm90"]}
    elif dev_rounds.get("calls") != n_lin + 3:
        raise AssertionError(f"LatticeFold+ prove [{label}]: {dev_rounds.get('calls')} device sumchecks, expected "
                             f"{n_lin + 3}")
    if launches != expected:
        raise AssertionError(f"LatticeFold+ prove [{label}]: launches {launches}, expected {expected}")
    check_permutations(f"LatticeFold+ prove [{label}]", perms)
    peak = peaks.pop("all")
    reserved = peaks.pop("reserved")
    check_peak(f"LatticeFold+ [{label}]", peak, device)
    rec = dict(L=L, prove_s=prove_s, sponge_s=sponge["s"], parts_s=parts, peak_bytes=peak,
               reserved_bytes=reserved, live_bytes=live, parts_peak_bytes=peaks, launches=launches,
               permutations=perms, sumcheck_host_perms=dev_rounds.get("host_perms", 0),
               sumcheck="host" if host_sumchecks else "device")
    log(f"[plus {label}] prove {prove_s:.3f} s (L={L}, {rec['sumcheck']} sumchecks; host sponge {sponge['s']:.3f} s; "
        f"parts { {k: round(v, 3) for k, v in parts.items()} }), peak device memory {peak} B ({live} B held at "
        f"its start; reserved {reserved} B; by part {peaks}), launches {launches}, {perms} Poseidon permutations")
    return proof, rec


def plane_route_check(label, scheme, Nb, seed, device, rec):
    """The byte-plane batch commit (kernels A and B, ``commit_batch_fused``)
    counted, and held against the Hopper commit kernel (``commit_batch_cm``)
    on a seeded batch of Nb witnesses at the scheme's (kappa, n); both
    routes' times are ``rec``'s (``commit_turns``, in turns). Not on the
    LatticeFold+ path: the cross-check of the route at its shapes."""
    from latticefold_torch.rings import plane_commit as pc

    ring, n = scheme.ring, scheme.n
    fcm = pc.empty_batch(ring, n, Nb, device)
    fcm.copy_(rand_field(ring, (ring.ncomp, n, ring.e, Nb), seed, device))
    got, launches = counted(f"commit_batch_fused [{label} Nb={Nb}]", lambda: scheme.commit_batch_fused(fcm),
                            {"plane_dot_sm90": -(-n // pc._K_SLICE), "plane_epilogue_diag": 1})
    err = int((got != scheme.commit_batch_cm(fcm)).sum().item())
    if err:
        raise AssertionError(f"commit_batch_fused [{label} Nb={Nb}]: {err} limbs differ from the commit kernel's")
    out = dict(Nb=Nb, launches=launches, fused_ms=rec["route_ms"], cm_ms=rec["ms"], old_ms=rec["old_ms"])
    log(f"[plus {label}] commit_batch_fused kappa={scheme.kappa} n={n} Nb={Nb}: equal to the Hopper commit kernel; "
        f"{out['fused_ms']:.4f} ms against its {out['cm_ms']:.4f} ms (the first commit kernel "
        f"{out['old_ms']:.4f} ms); launches {launches}")
    return out


def plus_kernel_checks(label, scheme, Nbs, device):
    """The Hopper commit kernel against the plain commit, the first commit
    kernel and the byte-plane route, and the route counted and against the
    Hopper kernel, at the scheme's (kappa, n) and each Nb. Returns
    ({(kernel, shape): numbers}, {Nb: route record})."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    kres, route = {}, {}
    for i, Nb in enumerate(Nbs):
        shape = f"kappa={scheme.kappa} n={scheme.n} Nb={Nb}"
        kres[("commit_sm90", shape)], kres[("commit", shape)] = check_commit(label, scheme, Nb, 20 + i, device, flush)
        route[f"Nb={Nb}"] = plane_route_check(label, scheme, Nb, 40 + i, device, kres[("commit_sm90", shape)])
    del flush
    torch.cuda.empty_cache()
    return kres, route


def run_plus_bench(device, kres_crt):
    """Phase 4a: ``PLUS_BENCH``. Kernel checks at the path's commit shapes
    (Nb 1, 2, 3 and k d), one counted ``PlusProver.prove`` (L = 1), the
    port's verifier on a fresh transcript, the proof's serialization round
    trip; then the same prove with the host-transcript sumchecks, which
    must give the same bytes, and in which the host transcript must make as
    many permutations more as the Poseidon kernel made in the first
    (``sumcheck_host_perms``; the pairs in turns are ``plus_bench_turns``,
    under ``--plus-sweep``). Returns (record, kernels JSON entries)."""
    import zlib

    from latticefold_torch import serialization as ser
    from latticefold_torch.plus import PlusProver, PlusTranscript, PlusVerifier, estimate_bound
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    n, k, kappa = PLUS_BENCH
    B = estimate_bound(ring.d * 128, 3, ring.d, k) + 1
    label = f"frog plus n={n} k={k} kappa={kappa}"
    t0 = time.perf_counter()
    scheme, c, pparams = plus_setup(n, k, kappa, B, device)
    setup_s = time.perf_counter() - t0
    log(f"[plus {label}] B={B} l={pparams.lin.decomp.l}: setup {setup_s:.2f} s")
    kres, route = plus_kernel_checks(label, scheme, (1, 2, 3, k * ring.d), device)
    prover = PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams)
    proof, rnd = plus_round(label, prover, c, 1, device)
    t0 = time.perf_counter()
    PlusVerifier(ring=ring, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams).verify(proof)
    verify_s = time.perf_counter() - t0
    blob = ser.serialize_plus_proof(ring, proof)
    # the same prove with the host-transcript sumchecks, after it: the same bytes
    host_prover = PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams)
    host_proof, host_rnd = plus_round(f"{label} host sumchecks", host_prover, c, 1, device, host_sumchecks=True)
    if ser.serialize_plus_proof(ring, host_proof) != blob:
        raise AssertionError(f"[plus {label}] the host-sumcheck prove gives other bytes than the device one")
    want = host_rnd["sumcheck_host_perms"] - rnd["sumcheck_host_perms"]
    if rnd["permutations"] != want:
        raise AssertionError(f"[plus {label}] the Poseidon kernel ran {rnd['permutations']} permutations, the host "
                             f"transcript {want} in the same sumchecks")
    log(f"[plus {label}] the Poseidon kernel's {want} permutations equal the host transcript's in the same sumchecks")
    del host_prover, host_proof
    if ser.serialize_plus_proof(ring, ser.deserialize_plus_proof(ring, blob)) != blob:
        raise AssertionError(f"[plus {label}] the proof does not survive a round trip")
    rec = dict(n=n, k=k, kappa=kappa, B=B, l=pparams.lin.decomp.l, setup_s=setup_s, verify_s=verify_s,
               proof_bytes=len(blob), proof_zlib_bytes=len(zlib.compress(blob)), route=route, **rnd,
               host_sumchecks=host_rnd, kernels={f"{kk}:{sh}": v for (kk, sh), v in kres.items()})
    log(f"[plus {label}] verify {verify_s:.3f} s: the port's verifier accepts; proof {len(blob)} B "
        f"({rec['proof_zlib_bytes']} B zlib)")
    entries = kernel_entries(label, "frog", n, k * ring.d, {**kres_crt, **kres}, rnd["launches"], None, kappa,
                             rnd["permutations"])
    del prover, proof, scheme, c
    return rec, entries


def run_plus_multi(device, kres_crt):
    """Phase 4b: ``PLUS_MULTI``, the reference's accumulation test. Kernel
    checks at its commit shapes (Nb 1, 2, 3 and k d); the rounds on one
    prover, each verified by one verifier that carries its transcript
    across rounds. From round 2 on the accumulator holds L = 3 instances.
    Round 3's peak must not pass round 2's by more than PLUS_PEAK_NOISE.
    Returns (record, kernels JSON entries: round 2's launches)."""
    import zlib

    import torch

    from latticefold_torch import serialization as ser
    from latticefold_torch.plus import PlusProver, PlusTranscript, PlusVerifier, estimate_bound
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    n, k, kappa, rounds = PLUS_MULTI
    B = estimate_bound(ring.d * 128, 3, ring.d, k) // 2
    label = f"frog plus n={n} k={k} kappa={kappa}"
    t0 = time.perf_counter()
    scheme, c, pparams = plus_setup(n, k, kappa, B, device)
    setup_s = time.perf_counter() - t0
    log(f"[plus {label}] B={B}: setup {setup_s:.2f} s")
    kres, route = plus_kernel_checks(label, scheme, (1, 2, 3, k * ring.d), device)
    prover = PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams)
    verifier = PlusVerifier(ring=ring, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams)
    recs = []
    for i in range(rounds):
        proof, rnd = plus_round(f"{label} round {i + 1}", prover, c, 1 if i == 0 else 3, device)
        t0 = time.perf_counter()
        verifier.verify(proof)
        verify_s = time.perf_counter() - t0
        blob = ser.serialize_plus_proof(ring, proof)
        recs.append(dict(round=i + 1, verify_s=verify_s, proof_bytes=len(blob),
                         proof_zlib_bytes=len(zlib.compress(blob)), **rnd))
        log(f"[plus {label}] round {i + 1}: verified in {verify_s:.3f} s (the verifier's transcript carried "
            f"across rounds); proof {len(blob)} B")
        del proof
    if rounds >= 3 and recs[2]["peak_bytes"] > recs[1]["peak_bytes"] * (1 + PLUS_PEAK_NOISE):
        raise AssertionError(f"[plus {label}] round 3's peak {recs[2]['peak_bytes']} B passes round 2's "
                             f"{recs[1]['peak_bytes']} B by more than {PLUS_PEAK_NOISE}")
    entries = kernel_entries(label, "frog", n, k * ring.d, {**kres_crt, **kres}, recs[1]["launches"], None, kappa,
                             recs[1]["permutations"])
    del prover, verifier, scheme, c
    torch.cuda.empty_cache()
    return dict(n=n, k=k, kappa=kappa, B=B, setup_s=setup_s, rounds=recs, route=route,
                kernels={f"{kk}:{sh}": v for (kk, sh), v in kres.items()}), entries


def plus_small_prove(dev):
    """``PLUS_SMALL`` proved on ``dev`` (and verified there on the card);
    returns the ``serialize_plus_proof`` bytes and the seconds taken."""
    from latticefold_torch import serialization as ser
    from latticefold_torch.plus import PlusProver, PlusTranscript, PlusVerifier, estimate_bound
    from latticefold_torch.rings.construct import get_ring

    t0 = time.perf_counter()
    ring = get_ring("frog")
    n, k, kappa = PLUS_SMALL
    B = estimate_bound(ring.d * 128, 3, ring.d, k) + 1
    scheme, c, pparams = plus_setup(n, k, kappa, B, dev)
    proof = PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams).prove([c])
    if dev.type == "cuda":
        PlusVerifier(ring=ring, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams).verify(proof)
    return ser.serialize_plus_proof(ring, proof), time.perf_counter() - t0


def run_plus_small(device, cpu_job=None):
    """Phase 4c: ``PLUS_SMALL`` proved once on the card (verified) and once
    on the CPU (``cpu_job``, the worker's ``plus_small_prove``; None: here,
    after the card's): the ``serialize_plus_proof`` bytes must be equal,
    and hash to the JAX prover's digest (PLUS_SMALL_SHA256)."""
    import hashlib

    import torch

    card, card_s = plus_small_prove(device)
    cpu, cpu_s = cpu_job.get(CPU_WAIT_S) if cpu_job else plus_small_prove(torch.device("cpu"))
    n, k, kappa = PLUS_SMALL
    if card != cpu:
        raise AssertionError("small LatticeFold+ fixture: the card's proof bytes differ from the CPU's")
    digest = hashlib.sha256(card).hexdigest()
    if digest != PLUS_SMALL_SHA256:
        raise AssertionError(f"small LatticeFold+ fixture: sha256 {digest}, the JAX prover's {PLUS_SMALL_SHA256}")
    log(f"[plus small n={n} k={k}] card {card_s:.1f} s (verified), CPU {cpu_s:.1f} s: "
        f"equal proof bytes ({len(card)} B), the JAX prover's digest")
    return dict(n=n, k=k, kappa=kappa, card_s=card_s, cpu_s=cpu_s, proof_bytes=len(card), sha256=digest)


def plus_point(label, n, k, kappa, L, device, commit_nbs=(), setups=None):
    """One LatticeFold+ point on Frog: ``plus_setup`` at (n, k, kappa) with
    B = estimate_bound(d 128, 3, d, k) + 1 (kept in ``setups``, a dict, for
    the next point at the same (n, k, kappa), where given); with ``commit_nbs``, the kernel
    checks at (kappa, n) and each of those Nb (``plus_kernel_checks``);
    one counted ``PlusProver.prove`` of L copies of the instance in one
    round (``plus_round``); the port's verifier on a fresh transcript; the
    proof's serialization round trip. Returns (record, proof bytes,
    {(kernel, shape): numbers})."""
    import zlib

    import torch

    from latticefold_torch import serialization as ser
    from latticefold_torch.plus import PlusProver, PlusTranscript, PlusVerifier, estimate_bound
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    B = estimate_bound(ring.d * 128, 3, ring.d, k) + 1
    if setups is not None and (n, k, kappa) in setups:
        scheme, c, pparams, setup_s, setup_parts = setups[(n, k, kappa)]
    else:
        if setups:
            setups.clear()
            torch.cuda.empty_cache()
        setup_parts = {}
        t0 = time.perf_counter()
        with plus_timers(setup_parts):
            scheme, c, pparams = plus_setup(n, k, kappa, B, device)
        setup_s = time.perf_counter() - t0
        log(f"[plus {label}] B={B} l={pparams.lin.decomp.l}: setup {setup_s:.2f} s "
            f"({ {kk: round(v, 3) for kk, v in setup_parts.items()} })")
        if setups is not None:
            setups[(n, k, kappa)] = (scheme, c, pparams, setup_s, setup_parts)
    kres, route = plus_kernel_checks(label, scheme, commit_nbs, device) if commit_nbs else ({}, {})
    prover = PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams)
    proof, rnd = plus_round(label, prover, c, L, device, n_lin=L)
    del prover
    t0 = time.perf_counter()
    PlusVerifier(ring=ring, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams).verify(proof)
    verify_s = time.perf_counter() - t0
    blob = ser.serialize_plus_proof(ring, proof)
    if ser.serialize_plus_proof(ring, ser.deserialize_plus_proof(ring, blob)) != blob:
        raise AssertionError(f"[plus {label}] the proof does not survive a round trip")
    total = torch.cuda.get_device_properties(device).total_memory
    rec = dict(n=n, m=n // k, k=k, kappa=kappa, B=B, setup_s=setup_s, setup_parts_s=setup_parts,
               verify_s=verify_s, proof_bytes=len(blob),
               proof_zlib_bytes=len(zlib.compress(blob)), peak_share=rnd["peak_bytes"] / total, route=route, **rnd)
    log(f"[plus {label}] verify {verify_s:.3f} s: the port's verifier accepts; proof {len(blob)} B "
        f"({rec['proof_zlib_bytes']} B zlib); peak {rec['peak_share']:.3f} of the card's {total} B")
    del proof, scheme, c
    torch.cuda.empty_cache()
    return rec, blob, kres


def run_plus_top(device, kres_crt):
    """Phase 4d: ``PLUS_TOP``, the JAX bench's defaults at the top of the
    reference sweep. The tensor-core CRT held at the path's new shapes
    (icrt N = m, crt and icrt N = n: ``check_crt``), then ``plus_point``
    with the commit kernel held at (kappa, n) and Nb 1, 2, 3 and k d.
    Returns (record, kernels JSON entries)."""
    import torch

    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    n, k, kappa = PLUS_TOP
    label = f"frog plus n={n} k={k} kappa={kappa}"
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    kcrt = check_crt(label, ring, n, device, flush, n // k)
    del flush
    torch.cuda.empty_cache()
    rec, _, kres = plus_point(label, n, k, kappa, 1, device, commit_nbs=(1, 2, 3, k * ring.d))
    kres = {**kcrt, **kres}
    rec["kernels"] = {f"{kk}:{sh}": v for (kk, sh), v in kres.items()}
    return rec, kernel_entries(label, "frog", n, k * ring.d, {**kres_crt, **kres}, rec["launches"], None, kappa,
                               rec["permutations"])


def run_plus_k3(device, kres_crt):
    """Phase 4e: ``PLUS_K3``, L instances in one round at k 3 (m k < n:
    ``ComR1CS.new`` pads f with zero rows), through ``plus_point`` with the
    commit kernel held at (kappa, n, k d); the proof bytes must hash to
    the JAX prover's digest (``PLUS_K3_SHA256``). Returns (record, kernels
    JSON entries)."""
    import hashlib

    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    n, k, kappa, L = PLUS_K3
    label = f"frog plus n={n} k={k} kappa={kappa} L={L}"
    rec, blob, kres = plus_point(label, n, k, kappa, L, device, commit_nbs=(k * ring.d,))
    rec["sha256"] = hashlib.sha256(blob).hexdigest()
    if rec["sha256"] != PLUS_K3_SHA256:
        raise AssertionError(f"[plus {label}] sha256 {rec['sha256']}, the JAX prover's {PLUS_K3_SHA256}")
    log(f"[plus {label}] the JAX prover's digest")
    rec["kernels"] = {f"{kk}:{sh}": v for (kk, sh), v in kres.items()}
    return rec, kernel_entries(label, "frog", n, k * ring.d, {**kres_crt, **kres}, rec["launches"], None, kappa,
                               rec["permutations"])


def plus_bench_turns(device):
    """4a's instance proved by both provers in turns: device then host,
    host then device, device then host, each with 4a's bytes; each
    prover's median of three prove s and of its parts. Run by
    ``--plus-sweep`` (moved out of the default run for its time limit)."""
    from latticefold_torch import serialization as ser
    from latticefold_torch.plus import PlusProver, PlusTranscript, estimate_bound
    from latticefold_torch.rings.construct import get_ring

    ring = get_ring("frog")
    n, k, kappa = PLUS_BENCH
    B = estimate_bound(ring.d * 128, 3, ring.d, k) + 1
    label = f"frog plus n={n} k={k} kappa={kappa}"
    scheme, c, pparams = plus_setup(n, k, kappa, B, device)
    runs, blob = {"device": [], "host": []}, None
    for order in (("device", "host"), ("host", "device"), ("device", "host")):
        for kind in order:
            p = PlusProver(scheme=scheme, M=c.x.matrices, transcript=PlusTranscript(ring), params=pparams)
            got, r = plus_round(f"{label} {kind} sumchecks, in turns", p, c, 1, device,
                                host_sumchecks=kind == "host")
            got = ser.serialize_plus_proof(ring, got)
            if blob is not None and got != blob:
                raise AssertionError(f"[plus {label}] the {kind}-sumcheck prove in turns gives other bytes")
            blob = got
            runs[kind].append(r)
            del p
    turns = {kind: dict(prove_s=[r["prove_s"] for r in rs], median_s=statistics.median(r["prove_s"] for r in rs),
                        parts_median_s={k: statistics.median(r["parts_s"].get(k, 0.0) for r in rs)
                                        for k in rs[0]["parts_s"]})
             for kind, rs in runs.items()}
    log(f"[plus {label}] in turns (device, host; host, device; device, host): device sumchecks "
        f"{turns['device']['prove_s']} s (median {turns['device']['median_s']:.3f}), host sumchecks "
        f"{turns['host']['prove_s']} s (median {turns['host']['median_s']:.3f}); medians of the parts: "
        f"device { {k: round(v, 3) for k, v in turns['device']['parts_median_s'].items()} }, "
        f"host { {k: round(v, 3) for k, v in turns['host']['parts_median_s'].items()} }")
    return turns


def plus_peak_sweep(device):
    """LatticeFold+ against n, k, kappa and L (``PLUS_SWEEP``): at each point ``plus_point``
    (one prove of L instances in one round on the device sumchecks,
    counted, verified), recording prove s, the parts' s, verify s, peak
    and reserved bytes, each part's peak, proof bytes and the launches. A
    point that runs out of device memory is recorded as such, with the
    prover's innermost frames at the failed allocation. At kappa 5 the
    commit kernel is held at the point's commit shapes (``PLUS_SWEEP_COMMIT``).
    Then 4a's pairs in turns (``plus_bench_turns``). Writes
    chiprun_out/chip_smoke_plus_peaks.json. Returns (record, kernels JSON
    entries of the commit checks)."""
    import gc
    import traceback

    import torch

    from latticefold_torch.rings.construct import get_ring

    total = torch.cuda.get_device_properties(device).total_memory
    out, entries, setups = [], [], {}
    for i, (n, k, kappa, L) in enumerate(PLUS_SWEEP):
        label = f"sweep n={n} k={k} kappa={kappa} L={L}"
        nbs = PLUS_SWEEP_COMMIT if (n, kappa) == (1 << 19, 5) and L == 1 else ()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            rec, _, kres = plus_point(label, n, k, kappa, L, device, commit_nbs=nbs, setups=setups)
            if kres:
                rec["kernels"] = {f"{kk}:{sh}": v for (kk, sh), v in kres.items()}
                entries += kernel_entries(label, "frog", n, nbs[-1], kres, rec["launches"], None, kappa,
                                          rec["permutations"])
        except torch.OutOfMemoryError as e:
            # the prover's frames (plus/, arith/) and the innermost one
            tb = [f for f in traceback.extract_tb(e.__traceback__) if "latticefold_torch" in f.filename]
            at = [f for f in tb if os.sep + "plus" + os.sep in f.filename or os.sep + "arith" + os.sep in f.filename]
            frames = [f"{os.path.relpath(f.filename, HERE)}:{f.lineno} {f.name}: {f.line}" for f in at[-3:] + tb[-1:]]
            rec = dict(n=n, m=n // k, k=k, kappa=kappa, L=L, out_of_memory=str(e).splitlines()[0],
                       at=frames, seconds_to_failure=time.perf_counter() - t0)
            log(f"[plus {label}] out of device memory: {rec}")
            del e
            gc.collect()
        rec["index"] = i
        out.append(rec)
        torch.cuda.empty_cache()
    setups.clear()
    torch.cuda.empty_cache()
    turns = plus_bench_turns(device)
    record = dict(card=nvidia_smi_line(), total_memory=total, points=out, bench_turns=turns)
    with open(os.path.join(OUT_DIR, "chip_smoke_plus_peaks.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    return record, entries


def run_plus_phase(device, kres_frog=None, cpu_small=None):
    """Phase 4, LatticeFold+: 4a, 4b, 4c (``cpu_small``: the worker's job
    for 4c's CPU prove, or None), 4d, 4e. ``kres_frog``: phase 2's Frog
    records, whose CRT shapes at crt N = 2^15 are this path's; without them
    (phase 4 alone) the CRT is held here at the path's shapes (icrt N = m,
    crt and icrt N = n). Returns (record, kernels JSON entries)."""
    import torch

    from latticefold_torch.rings.construct import get_ring

    if kres_frog is None:
        n, k, _ = PLUS_BENCH
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        kres_frog = check_crt("frog plus", get_ring("frog"), n, device, flush, n // k)
        del flush
    kres_crt = {key: v for key, v in kres_frog.items() if key[0] in ("crt_tc", "poseidon", "poseidon_perm")}
    record = {}
    record["bench"], entries = run_plus_bench(device, kres_crt)
    torch.cuda.empty_cache()
    record["multi"], ent = run_plus_multi(device, kres_crt)
    entries += ent
    record["small"] = run_plus_small(device, cpu_small)
    torch.cuda.empty_cache()
    record["top"], ent = run_plus_top(device, kres_crt)
    entries += ent
    record["k3"], ent = run_plus_k3(device, kres_crt)
    entries += ent
    return record, entries


def run_paths(device, smi, cpu_jobs, profile):
    """Phases 1b-4 (``cpu_jobs``: ``start_cpu_halves``'s jobs; ``profile``:
    run PROFILED's profiled prove). Returns (record, kernels JSON entries)."""
    import torch

    from latticefold_torch import params
    from latticefold_torch.commitment import AjtaiScheme
    from latticefold_torch.rings.construct import get_ring

    record = dict(card=smi, wit_len=WIT_LEN, rings={})
    # phase 1b: the byte-plane batch commit and the probes
    record["plane_commit"], entries = check_plane_commit(device)
    record["probes"], probe_entries = check_probes(device)
    entries += probe_entries
    # phases 2 and 3, one ring after the other
    chain_fold_proof = None  # the fold phase's proof on the chain's ring
    kres_by_ring, folds = {}, {}
    for name, (preset, kappa, reps) in PATHS.items():
        dp = getattr(params, preset)
        ring = get_ring(name)
        scheme = AjtaiScheme(ring, kappa, WIT_LEN * dp.L, seed=7, device=device)
        kres = kres_by_ring[name] = check_kernels(name, dp, scheme, device)
        fold = folds[name] = run_fold(name, dp, scheme, reps, device, profile=profile and name == PROFILED,
                                      device_nifs=name == DEVICE_NIFS_FOLD)
        steps = SMALL_CHAIN_STEPS if name == CHAIN[0] else 1
        card, card_s = small_fold_timed(name, device, steps)
        cpu, cpu_s = cpu_jobs[name].get(CPU_WAIT_S)
        if card != cpu:
            raise AssertionError(f"small fold [{name}]: the card's proof or accumulator bytes differ from the CPU's")
        fold["small_card_s"], fold["small_cpu_s"] = card_s, cpu_s
        log(f"[fold {name}] small fixture, {steps} step(s): the card's proof and accumulator bytes "
            f"equal the CPU's ({[len(b) for b in card[0]]} B of proof; card {card_s:.1f} s, CPU {cpu_s:.1f} s "
            f"in the worker)")
        proof_bytes = fold.pop("proof_bytes")
        if name == CHAIN[0]:
            chain_fold_proof = proof_bytes
        record["rings"][name] = dict(kernels={f"{k}:{s}": v for (k, s), v in kres.items()}, fold=fold)
        entries += kernel_entries(name, name, scheme.n, dp.K - 1, kres, fold["launches"],
                                  record["plane_commit"][f"{name} fold"])
        if fold["device_nifs"]:
            entries += kernel_entries(f"{name} DeviceNIFS", name, scheme.n, dp.K - 1, kres,
                                      fold["device_nifs"]["launches"], record["plane_commit"][f"{name} fold"],
                                      permutations=fold["device_nifs"]["permutations"])
        del scheme
        torch.cuda.empty_cache()

    # phase 3b: the IVC chain, and 3e: the chain through DeviceNIFS
    record["chain"] = run_chain_phase(device, chain_fold_proof)
    record["chain"]["card"] = smi
    record["fused_chain"] = run_fused_chain_phase(device, record["chain"])
    n_chain = WIT_LEN * getattr(params, PATHS[CHAIN[0]][0]).L
    entries += kernel_entries(f"{CHAIN[0]} DeviceNIFS chain", CHAIN[0], n_chain,
                              getattr(params, PATHS[CHAIN[0]][0]).K - 1, kres_by_ring[CHAIN[0]],
                              record["fused_chain"]["steps"][0]["launches"], record["plane_commit"][f"{CHAIN[0]} fold"],
                              permutations=record["fused_chain"]["steps"][0]["permutations"])
    # phase 3c: moderate b
    record["moderate_b"], ent = run_moderate_b_phase(device, kres_by_ring[MODERATE_B[0]], record["plane_commit"])
    entries += ent
    # phase 3d: big m
    record["big_m"], ent = run_bigm_phase(device, folds[BIGM[0]], chain_fold_proof, kres_by_ring[BIGM[0]],
                                          record["plane_commit"])
    entries += ent

    # phase 4: LatticeFold+
    record["plus"], ent = run_plus_phase(device, kres_by_ring["frog"], cpu_jobs["plus small"])
    entries += ent
    return record, entries


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive latticefold_torch's main paths on one NVIDIA GPU.")
    ap.add_argument("--profile", action="store_true",
                    help=f"also run one more {PROFILED} fold prove under torch.profiler (about 3 min)")
    ap.add_argument("--plus-sweep", action="store_true",
                    help="instead of the paths, LatticeFold+ over PLUS_SWEEP (plus_peak_sweep) and 4a's "
                         "provers in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from latticefold_torch import cuda
    except ImportError as e:
        print(f"chip_smoke: the latticefold_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "chip_smoke_run.log"), "w").close()

    # phase 1: the card and the build
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    built = cuda.build()
    log(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'up to date'} "
        f"(wall {time.perf_counter() - t0:.1f} s, parallel nvcc)")
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as fh:
        for k, v in cuda.BUILD_LOG.items():
            fh.write(f"== {k}\n{v}\n")

    if args.plus_sweep:
        record, entries = plus_peak_sweep(device)
    else:
        # the CPU halves of the card-against-CPU checks, beside the card's work
        pool = multiprocessing.get_context("spawn").Pool(1, initializer=cpu_worker_init)
        try:
            record, entries = run_paths(device, smi, start_cpu_halves(pool), args.profile)
        finally:
            pool.terminate()
            pool.join()

    # phase 5: the record
    tag = "_plus_sweep" if args.plus_sweep else ""
    with open(os.path.join(OUT_DIR, f"chip_smoke{tag}.json"), "w") as fh:
        json.dump(record, fh, indent=1)
    with open(os.path.join(OUT_DIR, f"chip_smoke{tag}_kernels.json"), "w") as fh:
        json.dump({"kernels": entries}, fh, indent=1)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
