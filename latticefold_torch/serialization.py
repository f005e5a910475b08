"""Canonical byte serialization for proofs and accumulator state.

The same format as the JAX package's serialization module, byte for byte:
deterministic little-endian layout, u32 length prefixes, field elements as
fixed 4*nl-byte LE integers, and the same ``MAGIC``. It is the
checkpoint/resume format for long folding chains: an accumulator
(``serialize_lcccs``) and its witness's coefficient digits
(``serialize_witness_f``) are enough to go on proving, since
``Witness.from_f_coeff`` recomputes the rest of the witness.

Proofs, accumulators and commitments are host objects (tuples of ints), so
this is host code; only the witness digits are tensors.

Not here yet: the LatticeFold+ proof format (``serialize_plus_proof``),
which comes with the port of the LatticeFold+ prover.
"""

from __future__ import annotations

import struct
from io import BytesIO
from typing import List

import numpy as np
import torch

from .arith.ccs import LCCCS, Commitment
from .device import resolve
from .nifs import LFProof
from .nifs.decomposition import DecompositionProof
from .nifs.folding import FoldingProof
from .nifs.linearization import LinearizationProof
from .rings.construct import Ring
from .sumcheck import SumcheckProof

MAGIC = b"LFTPU1\0\0"


class SerializationError(ValueError):
    pass


class Writer:
    def __init__(self, ring: Ring):
        self.ring = ring
        self.buf = BytesIO()

    def u32(self, v: int):
        self.buf.write(struct.pack("<I", v))

    def fq(self, v: int):
        self.buf.write(int(v).to_bytes(4 * self.ring.nl, "little"))

    def k_elt(self, k):
        for c in k:
            self.fq(c)

    def ring_elt(self, r):
        for comp in r:
            self.k_elt(comp)

    def ring_vec(self, v):
        self.u32(len(v))
        for r in v:
            self.ring_elt(r)

    def k_vec(self, v):
        self.u32(len(v))
        for k in v:
            self.k_elt(k)

    def commitment(self, cm: Commitment):
        self.ring_vec(cm.vals)

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    def __init__(self, ring: Ring, data: bytes):
        self.ring = ring
        self.buf = BytesIO(data)

    def magic(self, tag: bytes = MAGIC):
        if self.buf.read(len(tag)) != tag:
            raise SerializationError("bad magic")

    def u32(self) -> int:
        return struct.unpack("<I", self.buf.read(4))[0]

    def fq(self) -> int:
        return int.from_bytes(self.buf.read(4 * self.ring.nl), "little")

    def k_elt(self):
        return tuple(self.fq() for _ in range(self.ring.e))

    def ring_elt(self):
        return tuple(self.k_elt() for _ in range(self.ring.ncomp))

    def ring_vec(self):
        return [self.ring_elt() for _ in range(self.u32())]

    def k_vec(self):
        return [self.k_elt() for _ in range(self.u32())]

    def commitment(self) -> Commitment:
        return Commitment(self.ring, self.ring_vec())


# ---------------------------------------------------------------------------


def _write_sumcheck(w: Writer, p: SumcheckProof):
    w.u32(len(p.round_evals))
    for evals in p.round_evals:
        w.ring_vec(evals)


def _read_sumcheck(r: Reader) -> SumcheckProof:
    return SumcheckProof([r.ring_vec() for _ in range(r.u32())])


def _write_nested(w: Writer, vv: List[list]):
    w.u32(len(vv))
    for v in vv:
        w.ring_vec(v)


def _read_nested(r: Reader):
    return [r.ring_vec() for _ in range(r.u32())]


def serialize_proof(ring: Ring, proof: LFProof) -> bytes:
    w = Writer(ring)
    w.buf.write(MAGIC)
    lp = proof.linearization_proof
    _write_sumcheck(w, lp.sumcheck)
    w.ring_vec(lp.v)
    w.ring_vec(lp.u)
    for dp in (proof.decomposition_proof_l, proof.decomposition_proof_r):
        _write_nested(w, dp.u_s)
        _write_nested(w, dp.v_s)
        _write_nested(w, dp.x_s)
        w.u32(len(dp.y_s))
        for y in dp.y_s:
            w.commitment(y)
    fp = proof.folding_proof
    _write_sumcheck(w, fp.sumcheck)
    _write_nested(w, fp.theta_s)
    _write_nested(w, fp.eta_s)
    return w.getvalue()


def deserialize_proof(ring: Ring, data: bytes) -> LFProof:
    r = Reader(ring, data)
    r.magic()
    lp = LinearizationProof(sumcheck=_read_sumcheck(r), v=r.ring_vec(), u=r.ring_vec())
    dps = []
    for _ in range(2):
        u_s = _read_nested(r)
        v_s = _read_nested(r)
        x_s = _read_nested(r)
        y_s = [r.commitment() for _ in range(r.u32())]
        dps.append(DecompositionProof(u_s=u_s, v_s=v_s, x_s=x_s, y_s=y_s))
    fp = FoldingProof(sumcheck=_read_sumcheck(r), theta_s=_read_nested(r), eta_s=_read_nested(r))
    return LFProof(
        linearization_proof=lp,
        decomposition_proof_l=dps[0],
        decomposition_proof_r=dps[1],
        folding_proof=fp,
    )


def serialize_lcccs(ring: Ring, acc: LCCCS) -> bytes:
    w = Writer(ring)
    w.buf.write(MAGIC)
    w.k_vec(acc.r)
    w.ring_vec(acc.v)
    w.commitment(acc.cm)
    w.ring_vec(acc.u)
    w.ring_vec(acc.x_w)
    w.ring_elt(acc.h)
    return w.getvalue()


def deserialize_lcccs(ring: Ring, data: bytes) -> LCCCS:
    r = Reader(ring, data)
    r.magic()
    return LCCCS(
        r=r.k_vec(), v=r.ring_vec(), cm=r.commitment(), u=r.ring_vec(),
        x_w=r.ring_vec(), h=r.ring_elt(),
    )


def serialize_witness_f(ring: Ring, f_coeff: torch.Tensor) -> bytes:
    """Witness persistence: the canonical f_coeff digits [N, d, nl] as u32
    words (the rest of the Witness is recomputable via
    Witness.from_f_coeff). Raises on a limb outside [0, 2^32)."""
    if f_coeff.dim() != 3:
        raise SerializationError(f"expected f_coeff [N, d, nl], got {tuple(f_coeff.shape)}")
    arr = f_coeff.detach().cpu().numpy()
    if arr.size and (arr.min() < 0 or arr.max() >= 1 << 32):
        raise SerializationError("f_coeff limb outside [0, 2^32)")
    header = struct.pack("<III", *arr.shape)
    return MAGIC + header + arr.astype("<u4").tobytes()


def deserialize_witness_f(ring: Ring, data: bytes, device=None) -> torch.Tensor:
    """Bytes -> f_coeff [N, d, nl] int64 limb tensor on ``device`` (None:
    CUDA, as every entry point of the port)."""
    if data[:8] != MAGIC:
        raise SerializationError("bad magic")
    n, d, nl = struct.unpack("<III", data[8:20])
    arr = np.frombuffer(data[20:], dtype="<u4").reshape(n, d, nl)
    return torch.from_numpy(arr.astype(np.int64)).to(resolve(device))
