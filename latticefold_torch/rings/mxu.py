"""Ajtai commitment contraction over NTT-form ring elements.

cm[k, b, c] = sum_n A[k, n, c] *_K f[n, b, c]  -- the function the JAX
package computes with ``rings/mxu.py:ajtai_commit`` and with its fused
Pallas kernel ``rings/pallas_commit.py``. On a CUDA tensor ``ajtai_commit``
launches the hand-written Hopper kernel ``csrc/commit_sm90_kernel.cu`` for
every width n and batch; on a CPU tensor it runs the plain version beside
it. Nothing falls back from one to the other. ``_commit_kernel``
(``csrc/commit_kernel.cu``, the first design) is the new kernel's in-call
baseline, launched by no path.

The second half is the JAX package's byte-plane route in plain torch
(``to_planes`` ... ``ajtai_commit_cm``): the reference that the kernels of
``rings/plane_commit.py`` are held against.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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
    """(nchunks, chunk, TN) of ``_commit_kernel``: how pass 1 splits the sum over n across blocks
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
    """Launch csrc/commit_kernel.cu (both passes) on CUDA tensors: the first
    design, the Hopper kernel's in-call baseline (no path calls it). An (nl, e)
    without a template instance there makes the launcher return an error
    code, which ``cuda.check`` raises."""
    dev = f.device
    kappa, n = matrix.shape[0], matrix.shape[1]
    Nb = f.shape[1]
    if f.shape[0] != n:
        raise ValueError(f"witness length {f.shape[0]} != matrix width {n}")
    cuda.require_tensor(matrix, "commit matrix", dev)
    cuda.require_tensor(f, "commit witness", dev)
    nchunks, chunk, tn = commit_plan(ring, kappa, n, Nb, _sms(dev))
    S = 2 * ring.e - 1
    partial = torch.empty(
        (nchunks, ring.ncomp, kappa * Nb, S, ring.nl), dtype=torch.int64, device=dev
    )
    out = torch.empty(
        (kappa, Nb, ring.ncomp, ring.e, ring.nl), dtype=torch.int64, device=dev
    )
    red = _red(ring, dev)
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


# the Hopper kernel's plan (csrc/commit_sm90.cuh)
_SM90_THREADS = 256       # the most threads of a pass-1 block (cm90::max_threads) ...
_SM90_WIDE_THREADS = 512  # ... and of a staged one-pair tile of nl 2 or 8
_SM90_SHARED_THREADS = 320  # the most threads of a block that two can share an SM with (~100 registers)
_SM90_ALONE = 1.2         # the plan's weight on a block that cannot (chosen on the card, PERF.md section 6)
_SM90_SMEM = 100 * 1024   # the most staged bytes of a block: two blocks an SM
_SM90_TN = 64             # the most n rows a stage
_SM90_BLOCKS_PER_SM = (2, 8)  # pass-1 blocks to aim for on each SM: at least, and where chunks stay long
_SM90_MIN_STAGES = 4      # stages a chunk keeps when the plan cuts n finer than the least blocks
_SM90_PARTIAL_SHARE = 16  # partial sums at most 1/16 of the bytes of A and f, past the least blocks
# (nl, e) -> the register tiles (KT, BT) of (k, b) pairs a thread may own,
# the first with kappa >= KT and Nb >= BT taken; the instances of
# commit_sm90_kernel.cu, chosen on the card (PERF.md, section 6). BabyBear
# and Goldilocks keep (1, 1): e^2 = 81 and 9 products a pair already reuse
# each loaded value e times, and a second pair's accumulators cost the
# occupancy that hides the carry chains' latency.
_SM90_TILES = {(1, 9): ((1, 1),), (2, 3): ((1, 1),), (2, 4): ((2, 1), (1, 1)),
               (8, 1): ((1, 2), (2, 1), (1, 1))}


class CommitPlan(NamedTuple):
    """How ``csrc/commit_sm90_kernel.cu`` cuts one call: register tile
    (kt x bt pairs a thread), whether f is read from device memory directly
    (one tile along k, so each f value has one reader) or staged, pair
    group (kg x bg tiles a block), lanes a tile, n rows a stage, the chunks
    of n, and what that makes."""

    kt: int
    bt: int
    direct: int
    kg: int
    bg: int
    lanes: int
    tn: int
    chunk: int
    nchunks: int
    fwarps: int
    groups: int
    threads: int
    smem: int


def _pitch_bytes(ring: Ring) -> int:
    """A staged row of ncomp e nl int64 lanes, in whole 128-byte lines."""
    return -(-ring.ncomp * ring.e * ring.nl * 8 // 128) * 128


@functools.lru_cache(maxsize=None)
def commit_sm90_plan(ring: Ring, kappa: int, n: int, Nb: int, sms: int) -> CommitPlan:
    """The Hopper commit kernel's plan for a card with ``sms`` SMs. Of the
    pair groups that fit a block (ncomp kg bg items of at most
    ``_SM90_THREADS`` threads, two stage buffers in
    ``_SM90_SMEM``) it takes
    the one whose blocks read the fewest rows of A and f (A once per group
    along b, f once per group along k), weighed by how full its groups
    are and by whether two blocks share an SM, then the most threads, then
    the deepest stage; the lanes of an item are the largest power of two that
    fits the threads, the stage's rows and a warp. The chunks of n make at
    least 2 blocks an SM, and up to 8 while a chunk keeps
    ``_SM90_MIN_STAGES`` stages: the more blocks, the shorter the tail of
    the last wave, and while the partial sums stay under 1/16 of the bytes
    of A and f. Pass 2 gives an output the fewest warps (up to 8) that
    leave each thread at most one chunk, or eight warps."""
    kt, bt = next(t for t in _SM90_TILES[(ring.nl, ring.e)] if kappa >= t[0] and Nb >= t[1])
    ktiles, btiles = -(-kappa // kt), -(-Nb // bt)
    direct = int(ktiles == 1)
    pitch = _pitch_bytes(ring)
    max_threads = _SM90_WIDE_THREADS if not direct and (kt, bt) == (1, 1) and ring.nl >= 2 else _SM90_THREADS
    best = None
    for kg in range(1, ktiles + 1):
        for bg in range(1, btiles + 1):
            items = ring.ncomp * kg * bg
            if items > max_threads:
                break
            tn = min(_SM90_TN, _SM90_SMEM // (2 * (kg * kt + (0 if direct else bg * bt)) * pitch))
            if tn < 1:
                continue
            lanes = 1
            while lanes * 2 <= min(32, tn, max_threads // items):
                lanes *= 2
            tn = tn // lanes * lanes
            kgroups, bgroups = -(-ktiles // kg), -(-btiles // bg)
            reads = kappa * bgroups + Nb * kgroups
            # a ragged last group idles part of the card: weigh the reads by
            # the groups' tiles over the tiles there are; a block of more
            # than _SM90_SHARED_THREADS runs alone on its SM (registers):
            # weigh it by _SM90_ALONE
            cost = reads * kgroups * kg * bgroups * bg / (ktiles * btiles)
            if items * lanes > _SM90_SHARED_THREADS:
                cost *= _SM90_ALONE
            key = (cost, -items * lanes, -tn)
            if best is None or key < best[0]:
                best = (key, kg, bg, lanes, tn)
    if best is None:
        raise ValueError(f"commit_sm90: no pair group fits a block (ncomp {ring.ncomp}, kappa {kappa}, Nb {Nb})")
    _, kg, bg, lanes, tn = best
    groups = -(-ktiles // kg) * -(-btiles // bg)
    least, most = (-(-b * sms // groups) for b in _SM90_BLOCKS_PER_SM)
    row_bytes = ring.ncomp * ring.e * ring.nl * 8
    partial_bytes = ring.ncomp * kappa * Nb * (2 * ring.e - 1) * _acc_words(ring) * 8  # a chunk's
    cap = (kappa + Nb) * n * row_bytes // (_SM90_PARTIAL_SHARE * partial_bytes)
    nchunks = max(1, min(n, max(least, min(most, n // (_SM90_MIN_STAGES * tn), cap))))
    chunk = -(-n // nchunks)
    nchunks = -(-n // chunk)
    threads = -(-ring.ncomp * kg * bg * lanes // 32) * 32
    smem = 2 * (kg * kt + (0 if direct else bg * bt)) * tn * pitch
    fwarps = 1
    while fwarps < 8 and 32 * fwarps < nchunks:
        fwarps *= 2
    return CommitPlan(kt, bt, direct, kg, bg, lanes, tn, chunk, nchunks, fwarps, groups, threads, smem)


def _acc_words(ring: Ring) -> int:
    """u64 words of the field's lazy accumulator (csrc/field{32,64,256}.cuh)."""
    return {1: 2, 2: 3, 8: 9}[ring.nl]


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _red(ring: Ring, device: torch.device):
    """``ops.red_rows`` on ``device``, copied there once (a copy from host
    memory at every call would wait for the stream)."""
    return ops.red_rows(ring, device)


def _aligned(t):
    """``t`` itself when its data starts 16 bytes aligned (the kernel's
    16-byte copies need it), else a copy in fresh storage."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _commit_sm90(ring: Ring, matrix, f, mode: int = 3, partial=None):
    """Launch csrc/commit_sm90_kernel.cu on CUDA tensors: pass 1 (the
    partial sums of each chunk of n) and pass 2 (the sum over chunks, one
    reduction, the y^(e+k) fold). ``mode`` 1 or 2 runs one pass alone, on
    the ``partial`` scratch it is given (to time them apart; such calls
    are not counted). Returns (out, partial)."""
    dev = f.device
    kappa, n = matrix.shape[0], matrix.shape[1]
    Nb = f.shape[1]
    if f.shape[0] != n:
        raise ValueError(f"witness length {f.shape[0]} != matrix width {n}")
    if tuple(matrix.shape[2:]) != (ring.ncomp, ring.e, ring.nl) or tuple(f.shape[2:]) != (ring.ncomp, ring.e, ring.nl):
        raise ValueError(f"commit_sm90: shapes {tuple(matrix.shape)} / {tuple(f.shape)} are not {ring.name}'s")
    cuda.require_tensor(matrix, "commit matrix", dev)
    cuda.require_tensor(f, "commit witness", dev)
    matrix, f = _aligned(matrix), _aligned(f)
    pl = commit_sm90_plan(ring, kappa, n, Nb, _sms(dev))
    S = 2 * ring.e - 1
    if partial is None:
        partial = torch.empty((pl.nchunks, ring.ncomp, kappa * Nb, S, _acc_words(ring)), dtype=torch.int64, device=dev)
    out = torch.empty((kappa, Nb, ring.ncomp, ring.e, ring.nl), dtype=torch.int64, device=dev)
    red = _red(ring, dev)
    fn = cuda.kernel("commit_sm90")
    code = fn(
        matrix.data_ptr(), f.data_ptr(), 0 if red is None else red.data_ptr(),
        partial.data_ptr(), out.data_ptr(), kappa, n, Nb, ring.ncomp, ring.e, ring.nl,
        pl.kt, pl.bt, pl.direct, pl.kg, pl.bg, pl.lanes, pl.tn, pl.chunk, pl.nchunks, pl.fwarps, mode,
        cuda.field_constants(ring.q, ring.nl), cuda.stream_handle(dev),
    )
    cuda.check(code, "commit_sm90")
    if mode == 3:
        cuda.LAUNCHES["commit_sm90"] += 1
    return out, partial


def ajtai_commit(ring: Ring, matrix, f):
    """Commit a batch of witnesses: f [n, Nb, ncomp, e, nl] ->
    [kappa, Nb, ncomp, e, nl] (matrix [kappa, n, ncomp, e, nl])."""
    if f.device.type == "cpu":
        return ajtai_commit_plain(ring, matrix, f)
    return _commit_sm90(ring, matrix, f.contiguous())[0]


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
