"""Ajtai commitment contraction over NTT-form ring elements.

cm[k, b, c] = sum_n A[k, n, c] *_K f[n, b, c]  -- the function the JAX
package computes with ``rings/mxu.py:ajtai_commit`` and with its fused
Pallas kernel ``rings/pallas_commit.py``. On a CUDA tensor ``ajtai_commit``
launches the hand-written kernel ``csrc/commit_kernel.cu`` for every width
n and batch; on a CPU tensor it runs the plain version beside it. Nothing
falls back from one to the other.

The second half is the JAX package's byte-plane route in plain torch
(``to_planes`` ... ``ajtai_commit_cm``): the reference that the kernels of
``rings/plane_commit.py`` are held against.
"""

from __future__ import annotations

import torch

from .. import cuda
from .. import modops as mo
from . import ops
from .construct import Ring

_BLOCKS_PER_SM = 8  # pass-1 blocks to aim for on each SM
_SMEM_BYTES = 48 * 1024


def ajtai_commit_plain(ring: Ring, matrix, f):
    """Plain version: matrix [kappa, n, c, e, nl], f [n, Nb, c, e, nl] ->
    [kappa, Nb, c, e, nl]. Every K product at once, then a modular tree sum
    over n."""
    prod = ops.ring_mul(ring, matrix[:, :, None], f[None])  # [kappa, n, Nb, ...]
    return ops.ring_sum(ring, prod, 1)


def commit_plan(ring: Ring, kappa: int, n: int, Nb: int, sms: int):
    """(nchunks, chunk, TN): how pass 1 splits the sum over n across blocks
    of a card with ``sms`` SMs and how many n it stages per shared-memory
    tile."""
    elem_bytes = 4 * ring.nl  # an F_q value in shared memory (u32, u64 or 4 x u64)
    tn = min(32, _SMEM_BYTES // (elem_bytes * ring.e * (kappa + Nb)))
    if tn < 1:
        raise ValueError(f"commit kernel: kappa + Nb = {kappa + Nb} too large")
    nchunks = max(1, min(-(-n // tn), -(-_BLOCKS_PER_SM * sms // ring.ncomp)))
    chunk = -(-n // nchunks)
    nchunks = -(-n // chunk)
    return nchunks, chunk, tn


def _commit_kernel(ring: Ring, matrix, f):
    """Launch csrc/commit_kernel.cu (both passes) on CUDA tensors. An (nl, e)
    without a template instance there makes the launcher return an error
    code, which ``cuda.check`` raises."""
    dev = f.device
    kappa, n = matrix.shape[0], matrix.shape[1]
    Nb = f.shape[1]
    if f.shape[0] != n:
        raise ValueError(f"witness length {f.shape[0]} != matrix width {n}")
    cuda.require_tensor(matrix, "commit matrix", dev)
    cuda.require_tensor(f, "commit witness", dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nchunks, chunk, tn = commit_plan(ring, kappa, n, Nb, sms)
    S = 2 * ring.e - 1
    partial = torch.empty(
        (nchunks, ring.ncomp, kappa * Nb, S, ring.nl), dtype=torch.int64, device=dev
    )
    out = torch.empty(
        (kappa, Nb, ring.ncomp, ring.e, ring.nl), dtype=torch.int64, device=dev
    )
    red = ops.red_rows(ring, dev)
    fn = cuda.kernel("commit")
    code = fn(
        matrix.data_ptr(), f.data_ptr(), 0 if red is None else red.data_ptr(),
        partial.data_ptr(), out.data_ptr(), kappa, n, Nb, ring.ncomp, ring.e,
        ring.nl, nchunks, chunk, tn, cuda.field_constants(ring.q, ring.nl),
        cuda.stream_handle(dev),
    )
    cuda.check(code, "commit")
    cuda.LAUNCHES["commit"] += 1
    return out


def ajtai_commit(ring: Ring, matrix, f):
    """Commit a batch of witnesses: f [n, Nb, ncomp, e, nl] ->
    [kappa, Nb, ncomp, e, nl] (matrix [kappa, n, ncomp, e, nl])."""
    if f.device.type == "cpu":
        return ajtai_commit_plain(ring, matrix, f)
    return _commit_kernel(ring, matrix, f.contiguous())


# ---------------------------------------------------------------------------
# Byte-plane route: plain torch versions of the JAX package's rings/mxu.py
# byte-plane helpers. They are the reference of rings/plane_commit.py, whose
# kernels compute the same limbs by another algorithm; nothing on a card
# path calls them. Byte planes are uint8, plane products and position values
# int64 (the JAX package's uint32 lo16/hi16 pairs summed without overflow).
# ---------------------------------------------------------------------------

K_CHUNK = 1 << 15  # 255 * 255 * 2^15 < 2^31: the JAX package's dot chunk


def to_planes(x):
    """u32 limbs [..., nl] (int64 lanes) -> uint8 byte planes [..., 4 nl],
    little-endian."""
    nl = x.shape[-1]
    stacked = torch.stack([(x >> (8 * b)) & 0xFF for b in range(4)], dim=-1)
    return stacked.reshape(x.shape[:-1] + (4 * nl,)).to(torch.uint8)


def _mont_const(m, v: int) -> int:
    """v (mod q) as a Montgomery-domain constant (an int; ``mo.mul_const``
    takes it as limbs)."""
    return v % m.q * (1 << (32 * m.nl)) % m.q


def adjust_lhs(m, a):
    """Premultiply a Montgomery-domain array by 2^32 mod q, so that the wide
    reduction by R2 = 2^(32 (nl + 1)) lands in the Montgomery domain:
    REDC_R2(sum a 2^32 R * b R) = (sum a b) R."""
    return mo.mul_const(m, a, _mont_const(m, 1 << 32))


def ajtai_precompute(ring: Ring, matrix):
    """[kappa, n, ncomp, e, nl] Montgomery Ajtai matrix -> lhs byte planes
    [ncomp, kappa e, n, 4 nl] (component-batched)."""
    kappa, n = matrix.shape[0], matrix.shape[1]
    adj = adjust_lhs(ring.fq, matrix)
    a = adj.permute(2, 0, 3, 1, 4).reshape(ring.ncomp, kappa * ring.e, n, ring.nl)
    return to_planes(a)


def _plane_dot(lhs_planes, rhs_planes):
    """lhs [.., M, K, DA], rhs [.., K, N, DB] uint8 -> (lo16, hi16) int64
    [.., M, DA, N, DB], K chunked at K_CHUNK as in the JAX package. Each
    chunk's dot runs in float64, exact: its sums stay below 2^31."""
    *bl, M, K, DA = lhs_planes.shape
    *br, K2, N, DB = rhs_planes.shape
    assert K == K2 and bl == br
    lhs = lhs_planes.movedim(-1, -2).reshape(tuple(bl) + (M * DA, K))
    rhs = rhs_planes.reshape(tuple(br) + (K, N * DB))
    lo = hi = 0
    for k0 in range(0, K, K_CHUNK):
        p = torch.matmul(lhs[..., k0 : k0 + K_CHUNK].double(),
                         rhs[..., k0 : k0 + K_CHUNK, :].double()).long()
        lo = lo + (p & 0xFFFF)
        hi = hi + (p >> 16)
    shape = tuple(bl) + (M, DA, N, DB)
    return lo.reshape(shape), hi.reshape(shape)


def _group_positions(lo, hi, DA: int, DB: int):
    """Group plane products by byte position s = i + j: position values u[s]
    for s in [0, DA + DB) (hi16 halves enter two positions up)."""
    S = DA + DB - 1
    conv_lo = [None] * S
    conv_hi = [None] * S
    for i in range(DA):
        for j in range(DB):
            s = i + j
            l, h = lo[..., :, i, :, j], hi[..., :, i, :, j]
            conv_lo[s] = l if conv_lo[s] is None else conv_lo[s] + l
            conv_hi[s] = h if conv_hi[s] is None else conv_hi[s] + h
    zero = torch.zeros_like(conv_lo[0])
    u = []
    for s in range(S + 2):
        v = conv_lo[s] if s < S else zero
        if 2 <= s and conv_hi[s - 2] is not None:
            v = v + conv_hi[s - 2]
        u.append(v)
    return u


def _carry_pack(u_list, out_limbs: int):
    """Base-256 carry propagation of position values into ``out_limbs``
    u32 limbs."""
    zero = torch.zeros_like(u_list[0])
    u = list(u_list) + [zero] * (4 * out_limbs - len(u_list))
    bytes_out = []
    carry = zero
    for s in range(4 * out_limbs):
        t = u[s] + carry
        bytes_out.append(t & 0xFF)
        carry = t >> 8
    return [b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
            for b0, b1, b2, b3 in zip(*[iter(bytes_out)] * 4)]


def _redc_wide_list(m, t_limbs):
    """Montgomery reduction by R2 = 2^(32 (len(t_limbs) - nl)): the nl limbs
    of T R2^-1 mod q, canonical. Requires T < q R2. Word-level REDC: each
    round zeroes the low limb with mu = t0 (-q^-1 mod 2^32), adds mu q and
    drops the limb; a guard limb takes the ripple carries."""
    nl = m.nl
    q = [int(v) for v in m.q_limbs]
    t = list(t_limbs) + [torch.zeros_like(t_limbs[0])]
    for _ in range(len(t_limbs) - nl):
        mu = (t[0] * m.ninv) & mo.MASK32
        c = 0
        for j in range(nl):
            p = mu * q[j] + t[j] + c  # < 2^64: int64 keeps its low 64 bits
            t[j] = p & mo.MASK32
            c = (p >> 32) & mo.MASK32
        for j in range(nl, len(t)):
            s = t[j] + c
            t[j] = s & mo.MASK32
            c = s >> 32
        t = t[1:]
    return mo._reduce_once(m, t[:nl], t[nl])  # value < 2q


def _redc_wide(m, t_limbs):
    """``_redc_wide_list`` stacked to [..., nl]."""
    return mo._pack(_redc_wide_list(m, t_limbs))


def _ext_fold(ring: Ring, P, kappa: int, Nb: int):
    """Fold the (i, j) K-coordinate pair products with the reduction rows of
    m(y). P: [c, kappa e, e Nb, nl] Montgomery -> [kappa, Nb, c, e, nl]."""
    m, e, ncomp, nl = ring.fq, ring.e, ring.ncomp, ring.nl
    P = P.reshape(ncomp, kappa, e, e, Nb, nl)
    conv = [None] * (2 * e - 1)
    for i in range(e):
        for j in range(e):
            term = P[:, :, i, j]
            conv[i + j] = term if conv[i + j] is None else mo.add(m, conv[i + j], term)
    out = conv[:e]
    if e > 1:
        red = ops.red_rows(ring, P.device)  # [e-1, e, nl]
        for k in range(e - 1):
            prod = mo.mont_mul(m, conv[e + k][..., None, :], red[k])  # [c, kappa, Nb, e, nl]
            for t in range(e):
                out[t] = mo.add(m, out[t], prod[..., t, :])
    return torch.stack(out, dim=-2).permute(1, 2, 0, 3, 4)  # [kappa, Nb, c, e, nl]


def ajtai_commit_cm(ring: Ring, lhs_planes, fcm):
    """The byte-plane commit on a component-major witness batch, plain:
    lhs_planes from ``ajtai_precompute``, fcm [ncomp, n, e, Nb, nl] ->
    [kappa, Nb, ncomp, e, nl]."""
    m, e, ncomp, nl = ring.fq, ring.e, ring.ncomp, ring.nl
    kappa = lhs_planes.shape[1] // e
    n, Nb = fcm.shape[1], fcm.shape[3]
    rhs_planes = to_planes(fcm.reshape(ncomp, n, e * Nb, nl))
    DA, DB = lhs_planes.shape[-1], rhs_planes.shape[-1]
    lo, hi = _plane_dot(lhs_planes, rhs_planes)  # [c, kappa e, DA, e Nb, DB]
    u = _group_positions(lo, hi, DA, DB)
    P = _redc_wide(m, _carry_pack(u, 2 * nl + 1))  # [c, kappa e, e Nb, nl]
    return _ext_fold(ring, P, kappa, Nb)
