"""End-to-end LatticeFold IVC chain: prove, serialize, verify, with timings.

The counterpart of the JAX package's ``examples/e2e.py`` (itself a mirror
of the reference's examples/e2e.rs:100-147): build the dummy identity
R1CS, bootstrap the accumulator with one linearization, fold ``--steps``
times into it with ``nifs.prove``, print the last proof's size (raw and
zlib-compressed, after a ``deserialize_proof`` round trip), replay every
step in the verifier and check that the folded witness opens the folded
commitment.

  python -m latticefold_torch.e2e [--ring goldilocks] [--wit-len 512]
                                  [--x-len 1] [--kappa 4] [--steps 1]
                                  [--device cuda] [--fused]

It runs on the card unless ``--device cpu`` is given; without a card it
raises. Each fold takes the path ``nifs.use_big_m`` chooses from the ring,
m and the device's memory (the big-m path from m 2^18 on for Goldilocks
on an 80 GB card, e.g. ``--wit-len 32768``), and each step's line names
it. ``--fused`` folds through ``nifs.device_step.DeviceNIFS`` instead, the
prover with the transcript on the device (the same proofs; presets with
B < 2^16: not Stark's), as the JAX example's ``--fused`` does. ``run_chain``
does the work and returns each step's proof, prove seconds, kernel
launches and peak device memory, for callers that check a chain rather
than print one.
"""

from __future__ import annotations

import argparse
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from . import cuda
from . import nifs
from . import serialization as ser
from .arith.ccs import CCCS, CCS, LCCCS, get_test_dummy_r1cs, get_test_dummy_z_split_ntt
from .arith.witness import Witness
from .commitment import AjtaiScheme
from .device import resolve
from .nifs import linearization
from .nifs.device_step import DeviceNIFS
from .params import PRESETS, DecompositionParams
from .rings import ops as rops
from .rings.construct import Ring, get_ring
from .transcript import Transcript

AJTAI_SEED = 7


@dataclass
class ChainSetup:
    """The fixed part of a chain: the CCS, the Ajtai scheme, the fresh
    instance folded in at every step, and the bootstrap accumulator."""

    ring: Ring
    dp: DecompositionParams
    ccs: CCS
    scheme: AjtaiScheme
    cm_i: CCCS
    wit: Witness
    acc0: LCCCS
    setup_s: float
    fused: Optional[DeviceNIFS] = None  # the device-transcript prover, when asked for


@dataclass
class Step:
    proof: nifs.LFProof
    prove_s: float
    launches: dict  # kernel -> launches in this step's prove (none on the CPU)
    peak_bytes: Optional[int]  # peak device memory of this step (None on the CPU)
    live_bytes: Optional[int]  # device memory held when the step began (None on the CPU)
    big_m: bool  # the path nifs.prove chose (nifs.use_big_m); False when fused
    transcript_state: tuple  # the step's transcript after the prove: (sponge ints, index, absorbing)


@dataclass
class ChainResult:
    setup: ChainSetup
    steps: List[Step] = field(default_factory=list)
    acc: Optional[LCCCS] = None  # the accumulator after the last step
    w_acc: Optional[Witness] = None  # its witness


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup_chain(ring_name: str = "goldilocks", wit_len: int = 512, x_len: int = 1,
                kappa: int = 4, device=None, fused: bool = False) -> ChainSetup:
    """The identity R1CS of ``wit_len`` columns with a witness and statement
    of ones, the Ajtai scheme of seed 7, and the accumulator bootstrapped by
    one linearization (examples/e2e.rs:77-92). ``fused``: fold through
    ``DeviceNIFS`` (raises ValueError for a preset it does not take)."""
    dev = resolve(device)
    ring = get_ring(ring_name)
    dp = PRESETS[ring_name]
    t0 = time.perf_counter()
    r1cs = get_test_dummy_r1cs(ring, x_len, wit_len, x_len + wit_len + 1)
    ccs = CCS.from_r1cs_padded(ring, r1cs, W=x_len + wit_len + 1, L=dp.L)
    _, x_ccs, w_host = get_test_dummy_z_split_ntt(ring, x_len, wit_len)
    w_host = [ring.one()] * wit_len  # identity R1CS: all-ones z
    x_ccs = [ring.one()] * x_len
    scheme = AjtaiScheme(ring, kappa, wit_len * dp.L, seed=AJTAI_SEED, device=dev)
    wit = Witness.from_w_ccs(ring, dp, rops.to_device(ring, w_host, dev), n_pad=ccs.m)
    cm_i = CCCS(cm=wit.commit(scheme), x_ccs=x_ccs)
    acc0, _ = linearization.prove(cm_i, wit, Transcript(ring), ccs)
    dn = DeviceNIFS(ccs, dp, scheme) if fused else None
    _sync(dev)
    return ChainSetup(ring, dp, ccs, scheme, cm_i, wit, acc0, time.perf_counter() - t0, dn)


def prove_step(s: ChainSetup, acc: LCCCS, w_acc: Witness):
    """One fold of the fresh instance into (acc, w_acc) on a fresh
    transcript. Returns (acc', w_acc', Step)."""
    dev = s.wit.f.device
    live = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
    transcript = Transcript(s.ring)
    cuda.reset_launches()
    t0 = time.perf_counter()
    if s.fused is not None:
        acc, w_acc, proof = s.fused.prove(acc, w_acc, s.cm_i, s.wit, transcript)
    else:
        acc, w_acc, proof = nifs.prove(acc, w_acc, s.cm_i, s.wit, transcript, s.ccs, s.scheme, s.dp)
    _sync(dev)
    prove_s = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    big_m = s.fused is None and nifs.use_big_m(s.ring.name, s.ccs.m, dev)
    ints, index, absorbing = transcript.snapshot_state()
    return acc, w_acc, Step(proof, prove_s, launches, peak, live, big_m, ([int(v) for v in ints], index, absorbing))


def fold_steps(s: ChainSetup, steps: int,
               on_step: Optional[Callable[[int, LCCCS, Witness, Step], None]] = None) -> ChainResult:
    """Fold the fresh instance ``steps`` times into the bootstrap
    accumulator. ``on_step(i, acc, w_acc, step)`` is called after step i
    (from 1) with the new accumulator and witness, e.g. to checkpoint them.
    Only the current accumulator's witness is kept between steps, so the
    peak device memory does not grow with ``steps``."""
    res = ChainResult(s)
    acc, w_acc = s.acc0, s.wit
    for i in range(1, steps + 1):
        acc, w_acc, step = prove_step(s, acc, w_acc)
        res.steps.append(step)
        if on_step is not None:
            on_step(i, acc, w_acc, step)
    res.acc, res.w_acc = acc, w_acc
    return res


def run_chain(ring_name: str = "goldilocks", wit_len: int = 512, x_len: int = 1,
              kappa: int = 4, steps: int = 1, device=None,
              on_step: Optional[Callable[[int, LCCCS, Witness, Step], None]] = None,
              fused: bool = False) -> ChainResult:
    """``setup_chain`` then ``fold_steps``."""
    return fold_steps(setup_chain(ring_name, wit_len, x_len, kappa, device, fused), steps, on_step)


def verify_chain(s: ChainSetup, proofs) -> LCCCS:
    """Replay every step's proof in the verifier from the bootstrap
    accumulator; returns the verifier's final accumulator (raises on a
    rejected step)."""
    vacc = s.acc0
    for proof in proofs:
        vacc = nifs.verify(vacc, s.cm_i, proof, Transcript(s.ring), s.ccs, s.dp)
    return vacc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m latticefold_torch.e2e")
    ap.add_argument("--ring", default="goldilocks")
    ap.add_argument("--wit-len", type=int, default=512)
    ap.add_argument("--x-len", type=int, default=1)
    ap.add_argument("--kappa", type=int, default=4)
    ap.add_argument("--steps", type=int, default=1, help="IVC fold steps")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused", action="store_true",
                    help="fold through nifs.device_step.DeviceNIFS (the transcript on the device)")
    args = ap.parse_args(argv)
    if args.fused and PRESETS[args.ring].B >= 1 << 16:
        ap.error(f"--fused is not offered for {args.ring}: DeviceNIFS takes B < 2^16, "
                 f"and the preset's B is {PRESETS[args.ring].B}")

    dev = resolve(args.device)
    dp = PRESETS[args.ring]
    print(f"Decomposition parameters: B={dp.B} L={dp.L} b={dp.b} K={dp.K}")
    print(f"ring={args.ring} wit_len={args.wit_len} kappa={args.kappa} device={dev}")

    s = setup_chain(args.ring, args.wit_len, args.x_len, args.kappa, dev, args.fused)
    print(f"Setup in {s.setup_s:.3f}s (includes first kernel builds)")

    def report(i, acc, w_acc, step):
        path = "fused" if args.fused else "big-m" if step.big_m else "standard"
        print(f"step {i - 1}: proof generated in {step.prove_s:.3f}s ({path} path)")

    res = fold_steps(s, args.steps, report)
    acc, w_acc = res.acc, res.w_acc

    blob = ser.serialize_proof(s.ring, res.steps[-1].proof)
    if ser.serialize_proof(s.ring, ser.deserialize_proof(s.ring, blob)) != blob:
        raise RuntimeError("proof serialization does not round-trip")
    print(f"Proof size: {len(blob)} bytes ({len(zlib.compress(blob))} bytes zlib-compressed)")

    t0 = time.perf_counter()
    vacc = verify_chain(s, [st.proof for st in res.steps])
    if vacc.cm != acc.cm or vacc.v != acc.v:
        raise RuntimeError("verifier/prover accumulator mismatch")
    print(f"all {args.steps} step(s) verified in {time.perf_counter() - t0:.3f}s")
    opens = w_acc.commit(s.scheme) == acc.cm
    print(f"folded witness opens folded commitment: {opens}")
    return 0 if opens else 1


if __name__ == "__main__":
    raise SystemExit(main())
