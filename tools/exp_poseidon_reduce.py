"""What the sponge kernel's reduction of lazy sums buys, measured in one call
on the card.

The sponge kernel (``csrc/poseidon_kernel.cu`` ``lf_poseidon_sponge``)
reduces its lazy sums with ``lf_reduce_fast`` (``csrc/poseidon.cuh``: three
Montgomery products at nl 1, the field's ``reduce`` otherwise). This script
builds a second copy of the kernel from the same sources with every
``lf_reduce_fast`` call replaced by the field's ``reduce``
(``csrc/field32.cuh``: four u64 remainders), holds its output equal to the
kernel's, and times both in turns (``chip_smoke.time_in_turns``) through
``transcript.device.sponge_call`` at every ring: the one-permutation call
of ``chip_smoke.check_poseidon`` cold and warm, and an absorb of 4 d values
(a degree-3 round message) warm, per permutation. At nl 2 and 8 both copies
run the same code: their pairs show the spread.

Run on a machine with a card, from the repository's root:

    python3 tools/exp_poseidon_reduce.py

It prints the card's name and power limit, one line a ring, and a JSON
record (also written to ``chiprun_out/exp_poseidon_reduce.json``).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

REPS = 200


def build_field_reduce_copy(cuda) -> ctypes.CDLL:
    """The sponge kernel's library built from a copy of ``csrc/`` in which
    every call ``lf_reduce_fast(f, x)`` is ``f.reduce(x)``."""
    os.makedirs(cuda.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cuda.BUILD_DIR)
    src = os.path.join(tmp, "csrc")
    shutil.copytree(cuda.CSRC, src)
    calls = 0
    for name in ("poseidon.cuh", "poseidon_kernel.cu"):
        path = os.path.join(src, name)
        with open(path) as fh:
            text, n = re.subn(r"lf_reduce_fast\(f, ", "f.reduce(", fh.read())
        calls += n
        with open(path, "w") as fh:
            fh.write(text)
    if calls == 0:
        raise RuntimeError("no lf_reduce_fast call found in the sponge kernel's sources")
    out = os.path.join(tmp, "libposeidon_field_reduce.so")
    cmd = [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", out, os.path.join(src, cuda.SOURCES["poseidon_kernel"])]
    subprocess.run(cmd, check=True)
    return ctypes.CDLL(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from latticefold_torch import cuda
    from latticefold_torch.rings.construct import get_ring
    from latticefold_torch.transcript import device as dtr
    from latticefold_torch.transcript.poseidon import get_config

    device = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    cuda.build(["poseidon_kernel"])
    fast = cuda.kernel("poseidon")
    lib = build_field_reduce_copy(cuda)
    plain = lib.lf_poseidon_sponge
    plain.argtypes = cuda._ARGTYPES["poseidon"][2]
    plain.restype = ctypes.c_int

    def on(fn, call):
        def run():
            cuda._fns["poseidon"] = fn
            try:
                return call()
            finally:
                cuda._fns["poseidon"] = fast
        return run

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rec = {"card": cs.nvidia_smi_line(), "reps": REPS, "rings": {}}
    for name in ("goldilocks", "frog", "babybear", "stark"):
        ring = get_ring(name)
        cfg = get_config(ring.q)
        k = cfg.rate - cs.POSEIDON_IDX
        state = cs.rand_field(ring, (cfg.rate + cfg.capacity,), 60, device)
        chunk = cs.rand_field(ring, (k + 1,), 61, device)
        n = 4 * ring.d
        vals = cs.rand_field(ring, (n,), 64, device)
        perms, _ = dtr.call_plan(n, cs.POSEIDON_IDX, False, cfg.rate)

        def one():
            return dtr.sponge_call(ring, state, chunk, k + 1, cs.POSEIDON_IDX, False)[0]

        def absorb():
            return dtr.sponge_call(ring, state, vals, n, cs.POSEIDON_IDX, False)[0]

        for call in (one, absorb):
            a, b = on(fast, call)(), on(plain, call)()
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: the field-reduce copy differs from the kernel on {call.__name__}")
        fns = {"fast": on(fast, one), "field": on(plain, one)}
        cold = cs.time_in_turns(fns, REPS, flush)
        warm = cs.time_in_turns(fns, REPS, None)
        ab = cs.time_in_turns({"fast": on(fast, absorb), "field": on(plain, absorb)}, REPS, None)
        r = dict(nl=ring.nl, cold_ms=cold, warm_ms=warm, absorb_values=n, absorb_permutations=perms,
                 absorb_ms_per_permutation={k2: v / perms for k2, v in ab.items()})
        rec["rings"][name] = r
        print(f"{name} (nl {ring.nl}): one-permutation call cold {cold['fast']:.6f} ms with lf_reduce_fast, "
              f"{cold['field']:.6f} with the field's reduce; warm {warm['fast']:.6f} / {warm['field']:.6f}; "
              f"a permutation inside an absorb of {n} ({perms} permutations), warm, "
              f"{r['absorb_ms_per_permutation']['fast']:.6f} / {r['absorb_ms_per_permutation']['field']:.6f}; "
              "equal outputs", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "exp_poseidon_reduce.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
