"""Canonical byte serialization for proofs and accumulator state.

The same format as the JAX package's serialization module, byte for byte:
deterministic little-endian layout, u32 length prefixes, field elements as
fixed 4*nl-byte LE integers, and the same ``MAGIC``. It is the
checkpoint/resume format for long folding chains: an accumulator
(``serialize_lcccs``) and its witness's coefficient digits
(``serialize_witness_f``) are enough to go on proving, since
``Witness.from_f_coeff`` recomputes the rest of the witness.

Proofs, accumulators and commitments are host objects (tuples of ints), so
this is host code; only the witness digits are tensors. LatticeFold+
proofs (``serialize_plus_proof``) carry coefficient-form ring elements: d
field elements each, behind their own header ``MAGIC + b"PLUS"``.
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
from .plus.cm import CmProof, InstanceEvals
from .plus.decomp import DecompProof
from .plus.mlin import LinB2X
from .plus.plus import PlusProof
from .plus.r1cs import ComR1CSProof
from .plus.rgchk import Dcom, DcomEvals, DecompParameters, FComs
from .plus.setchk import SetCheckOut
from .plus.sumcheck import SumcheckProof as PlusSumcheckProof
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


# ---------------------------------------------------------------------------
# LatticeFold+ proofs (coefficient-form payloads)
# ---------------------------------------------------------------------------

PLUS_MAGIC = MAGIC + b"PLUS"


def _w_coeffs(w: Writer, c: list):
    for v in c:
        w.fq(v)


def _r_coeffs(r: Reader) -> list:
    return [r.fq() for _ in range(r.ring.d)]


def _w_coeff_vec(w: Writer, v: List[list]):
    w.u32(len(v))
    for c in v:
        _w_coeffs(w, c)


def _r_coeff_vec(r: Reader) -> List[list]:
    return [_r_coeffs(r) for _ in range(r.u32())]


def _w_scalar_vec(w: Writer, v: List[int]):
    w.u32(len(v))
    for x in v:
        w.fq(x)


def _r_scalar_vec(r: Reader) -> List[int]:
    return [r.fq() for _ in range(r.u32())]


def _w_plus_sumcheck(w: Writer, p: PlusSumcheckProof):
    w.u32(len(p.round_evals))
    for evals in p.round_evals:
        _w_coeff_vec(w, evals)


def _r_plus_sumcheck(r: Reader) -> PlusSumcheckProof:
    return PlusSumcheckProof([_r_coeff_vec(r) for _ in range(r.u32())])


def serialize_plus_proof(ring: Ring, proof: PlusProof) -> bytes:
    """PlusProof (plus/plus.py) -> canonical bytes."""
    w = Writer(ring)
    w.buf.write(PLUS_MAGIC)
    # linb2x
    _w_coeff_vec(w, proof.linb2x.cm_g)
    w.u32(len(proof.linb2x.ro))
    for a, b in proof.linb2x.ro:
        w.fq(a)
        w.fq(b)
    w.u32(len(proof.linb2x.vo))
    for a, b in proof.linb2x.vo:
        _w_coeffs(w, a)
        _w_coeffs(w, b)
    # linearization proofs
    w.u32(len(proof.lproof))
    for lp in proof.lproof:
        _w_plus_sumcheck(w, lp.sumcheck)
        w.u32(lp.nvars)
        _w_scalar_vec(w, lp.r)
        for c in (lp.v, lp.va, lp.vb, lp.vc):
            _w_coeffs(w, c)
    # cm proof
    cp = proof.cmproof
    d = cp.dcom
    w.u32(d.out.nvars)
    _w_scalar_vec(w, d.out.r)
    _w_plus_sumcheck(w, d.out.sumcheck_proof)
    w.u32(len(d.out.e))
    for ek in d.out.e:
        w.u32(len(ek))
        for eset in ek:
            _w_coeff_vec(w, eset)
    _w_coeff_vec(w, d.out.b)
    w.u32(len(d.evals))
    for ev in d.evals:
        _w_scalar_vec(w, ev.v)
        _w_scalar_vec(w, ev.a)
        _w_coeff_vec(w, ev.b)
        _w_coeff_vec(w, ev.c)
    w.u32(len(d.fcoms))
    for fc in d.fcoms:
        _w_coeff_vec(w, fc.cm_f)
        _w_coeff_vec(w, fc.C_Mf)
        _w_coeff_vec(w, fc.cm_mtau)
    w.u32(d.dparams.b)
    w.u32(d.dparams.k)
    w.u32(d.dparams.l)
    w.u32(len(cp.comh))
    for ci in cp.comh:
        _w_coeff_vec(w, ci)
    for sp in cp.sumcheck_proofs:
        _w_plus_sumcheck(w, sp)
    for evs in cp.evals:
        w.u32(len(evs))
        for iev in evs:
            w.u32(len(iev.groups))
            for grp in iev.groups:
                _w_coeff_vec(w, grp)
    # decomp proof
    dp = proof.dproof
    _w_coeff_vec(w, list(dp.C[0]))
    _w_coeff_vec(w, list(dp.C[1]))
    for vs in dp.v:
        w.u32(len(vs))
        for a, b in vs:
            _w_coeffs(w, a)
            _w_coeffs(w, b)
    return w.getvalue()


def deserialize_plus_proof(ring: Ring, data: bytes) -> PlusProof:
    r = Reader(ring, data)
    r.magic(PLUS_MAGIC)
    cm_g = _r_coeff_vec(r)
    ro = [(r.fq(), r.fq()) for _ in range(r.u32())]
    vo = [(_r_coeffs(r), _r_coeffs(r)) for _ in range(r.u32())]
    linb2x = LinB2X(cm_g=cm_g, ro=ro, vo=vo)
    lproof = []
    for _ in range(r.u32()):
        sc = _r_plus_sumcheck(r)
        nvars = r.u32()
        rs = _r_scalar_vec(r)
        v, va, vb, vc = (_r_coeffs(r) for _ in range(4))
        lproof.append(ComR1CSProof(sumcheck=sc, nvars=nvars, r=rs, v=v, va=va, vb=vb, vc=vc))
    nvars = r.u32()
    out_r = _r_scalar_vec(r)
    out_sc = _r_plus_sumcheck(r)
    e = [[_r_coeff_vec(r) for _ in range(r.u32())] for _ in range(r.u32())]
    b = _r_coeff_vec(r)
    out = SetCheckOut(nvars=nvars, r=out_r, sumcheck_proof=out_sc, e=e, b=b)
    evals = [
        DcomEvals(v=_r_scalar_vec(r), a=_r_scalar_vec(r), b=_r_coeff_vec(r), c=_r_coeff_vec(r))
        for _ in range(r.u32())
    ]
    fcoms = [
        FComs(cm_f=_r_coeff_vec(r), C_Mf=_r_coeff_vec(r), cm_mtau=_r_coeff_vec(r))
        for _ in range(r.u32())
    ]
    dparams = DecompParameters(b=r.u32(), k=r.u32(), l=r.u32())
    dcom = Dcom(evals=evals, fcoms=fcoms, out=out, dparams=dparams)
    comh = [_r_coeff_vec(r) for _ in range(r.u32())]
    sps = (_r_plus_sumcheck(r), _r_plus_sumcheck(r))
    evs_pair = tuple(
        [InstanceEvals(groups=[_r_coeff_vec(r) for _ in range(r.u32())]) for _ in range(r.u32())]
        for _ in range(2)
    )
    cmproof = CmProof(dcom=dcom, comh=comh, sumcheck_proofs=sps, evals=evs_pair)
    C = (_r_coeff_vec(r), _r_coeff_vec(r))
    v = tuple([(_r_coeffs(r), _r_coeffs(r)) for _ in range(r.u32())] for _ in range(2))
    dproof = DecompProof(C=C, v=v)
    return PlusProof(linb2x=linb2x, lproof=lproof, cmproof=cmproof, dproof=dproof)


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
